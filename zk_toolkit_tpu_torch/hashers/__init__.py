from zk_toolkit_tpu_torch.hashers.sha256 import Sha256
from zk_toolkit_tpu_torch.hashers.sha512 import Sha512
from zk_toolkit_tpu_torch.hashers.hmac import Hmac, HmacSha256, HmacSha512
