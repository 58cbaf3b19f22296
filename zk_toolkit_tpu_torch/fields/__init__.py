from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem, PrimeFieldElems
