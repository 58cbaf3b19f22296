// Host-side 256-bit Montgomery batch engine + limb codec.
//
// The port's own copy of the JAX package's native/zkt_host.cpp (the same
// functions and entry points). It plays the role the herumi/mcl C++ library
// plays for the reference (reference mcl_rust FFI, mcl/mcl_fr.rs:17-382):
// fast host-side scalar-field arithmetic for CRS / trusted-setup
// generation, witness packing, and the data path feeding the card (the
// kernels in ../csrc do the batched group and pairing arithmetic).
//
// Scope: odd moduli up to 256 bits, 4x64-bit little-endian limbs, classic
// CIOS Montgomery multiplication with unsigned __int128 accumulation,
// batched add/sub/mul/to-mont/from-mont, Montgomery-trick batch inversion
// (one Fermat inversion + 3(n-1) muls), sequential power tables (w^0..w^{n-1}
// for NTT domains / Lagrange bases), and 64x16-bit limb repacking for the
// device arrays.
//
// Build: g++ -O3 -shared -fPIC -o libzkthost-<digest>.so zkt_host.cpp, run by
// host.py at first use into build/zk_toolkit_tpu_torch/ under the repository root.

#include <cstdint>
#include <cstring>
#include <cstddef>

typedef uint64_t u64;
typedef unsigned __int128 u128;

struct Mont {
    u64 p[4];
    u64 n0inv;    // -p^{-1} mod 2^64
    u64 r2[4];    // (2^256)^2 mod p
    u64 one[4];   // 2^256 mod p (Montgomery 1)
};

static inline int geq(const u64* a, const u64* b) {
    for (int i = 3; i >= 0; --i) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static inline u64 sub4(const u64* a, const u64* b, u64* out) {
    u64 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u64 bi = b[i] + borrow;
        u64 carry_in = (bi < b[i]) ? 1 : 0;  // b[i]+borrow overflowed
        u64 d = a[i] - bi;
        u64 br = (a[i] < bi) ? 1 : 0;
        out[i] = d;
        borrow = br | carry_in;
    }
    return borrow;
}

static inline u64 add4(const u64* a, const u64* b, u64* out) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
        c += (u128)a[i] + b[i];
        out[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

static void addmod(const Mont* m, const u64* a, const u64* b, u64* out) {
    u64 t[4];
    u64 carry = add4(a, b, t);
    u64 d[4];
    u64 borrow = sub4(t, m->p, d);
    if (carry || !borrow) memcpy(out, d, 32);
    else memcpy(out, t, 32);
}

static void submod(const Mont* m, const u64* a, const u64* b, u64* out) {
    u64 t[4];
    if (sub4(a, b, t)) {
        u64 t2[4];
        add4(t, m->p, t2);
        memcpy(out, t2, 32);
    } else {
        memcpy(out, t, 32);
    }
}

// CIOS Montgomery multiplication, 4 limbs.
static void mmul(const Mont* m, const u64* a, const u64* b, u64* out) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        // t += a[i] * b
        u128 c = 0;
        for (int j = 0; j < 4; ++j) {
            c += (u128)t[j] + (u128)a[i] * b[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (u64)c;
        t[5] = (u64)(c >> 64);
        // reduce: q = t[0] * n0inv; t = (t + q*p) >> 64
        u64 q = t[0] * m->n0inv;
        c = (u128)t[0] + (u128)q * m->p[0];
        c >>= 64;
        for (int j = 1; j < 4; ++j) {
            c += (u128)t[j] + (u128)q * m->p[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    u64 d[4];
    u64 borrow = sub4(t, m->p, d);
    if (t[4] || !borrow) memcpy(out, d, 32);
    else memcpy(out, t, 32);
}

static void mont_pow(const Mont* m, const u64* base, const u64* exp, u64* out) {
    u64 acc[4];
    memcpy(acc, m->one, 32);
    for (int bit = 255; bit >= 0; --bit) {
        mmul(m, acc, acc, acc);
        if ((exp[bit / 64] >> (bit % 64)) & 1) mmul(m, acc, base, acc);
    }
    memcpy(out, acc, 32);
}

extern "C" {

int zkt_mont_init(const u64* p_le, Mont* m) {
    memcpy(m->p, p_le, 32);
    if (!(m->p[0] & 1)) return -1;
    // n0inv = -p^{-1} mod 2^64 (Newton iteration)
    u64 inv = m->p[0];
    for (int i = 0; i < 6; ++i) inv *= 2 - m->p[0] * inv;
    m->n0inv = (u64)(0 - inv);
    // one = 2^256 mod p via 256 doublings of 1; r2 = 2^512 mod p likewise
    u64 x[4] = {1, 0, 0, 0};
    for (int i = 0; i < 512; ++i) {
        u64 t[4];
        u64 carry = add4(x, x, t);
        u64 d[4];
        u64 borrow = sub4(t, m->p, d);
        if (carry || !borrow) memcpy(x, d, 32);
        else memcpy(x, t, 32);
        if (i == 255) memcpy(m->one, x, 32);
    }
    memcpy(m->r2, x, 32);
    return 0;
}

void zkt_mul_batch(const Mont* m, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mmul(m, a + 4 * i, b + 4 * i, out + 4 * i);
}

void zkt_mul_scalar_batch(const Mont* m, const u64* a, const u64* s, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mmul(m, a + 4 * i, s, out + 4 * i);
}

void zkt_add_batch(const Mont* m, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) addmod(m, a + 4 * i, b + 4 * i, out + 4 * i);
}

void zkt_sub_batch(const Mont* m, const u64* a, const u64* b, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) submod(m, a + 4 * i, b + 4 * i, out + 4 * i);
}

void zkt_to_mont_batch(const Mont* m, const u64* a, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mmul(m, a + 4 * i, m->r2, out + 4 * i);
}

void zkt_from_mont_batch(const Mont* m, const u64* a, u64* out, size_t n) {
    u64 one[4] = {1, 0, 0, 0};
    for (size_t i = 0; i < n; ++i) mmul(m, a + 4 * i, one, out + 4 * i);
}

// Montgomery-form batch inversion: one Fermat exponentiation + 3(n-1) muls.
// Zero inputs produce zero outputs (caller guards, host-tier parity).
void zkt_inv_batch(const Mont* m, const u64* a, u64* out, size_t n) {
    u64* prefix = out;  // reuse out as prefix storage
    u64 acc[4];
    memcpy(acc, m->one, 32);
    for (size_t i = 0; i < n; ++i) {
        memcpy(prefix + 4 * i, acc, 32);
        const u64* ai = a + 4 * i;
        u64 zero = !(ai[0] | ai[1] | ai[2] | ai[3]);
        if (!zero) mmul(m, acc, ai, acc);
    }
    // acc = prod of nonzero a_i; invert via Fermat (exp = p - 2)
    u64 exp[4];
    u64 two[4] = {2, 0, 0, 0};
    sub4(m->p, two, exp);
    u64 inv[4];
    mont_pow(m, acc, exp, inv);
    for (size_t i = n; i-- > 0;) {
        const u64* ai = a + 4 * i;
        u64 zero = !(ai[0] | ai[1] | ai[2] | ai[3]);
        if (zero) {
            memset(out + 4 * i, 0, 32);
        } else {
            u64 res[4];
            mmul(m, prefix + 4 * i, inv, res);
            mmul(m, inv, ai, inv);
            memcpy(out + 4 * i, res, 32);
        }
    }
}

// out[i] = base^i (Montgomery form), i = 0..n-1 — NTT/Lagrange power tables.
void zkt_pow_table(const Mont* m, const u64* base, u64* out, size_t n) {
    u64 acc[4];
    memcpy(acc, m->one, 32);
    for (size_t i = 0; i < n; ++i) {
        memcpy(out + 4 * i, acc, 32);
        mmul(m, acc, base, acc);
    }
}

void zkt_pow_batch(const Mont* m, const u64* bases, const u64* exp, u64* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mont_pow(m, bases + 4 * i, exp, out + 4 * i);
}

// 4x64-bit LE values -> K 16-bit limbs in uint32 lanes (device layout).
void zkt_repack16(const u64* vals, uint32_t* out, size_t n, int k) {
    for (size_t i = 0; i < n; ++i) {
        const u64* v = vals + 4 * i;
        uint32_t* o = out + (size_t)k * i;
        for (int j = 0; j < k && j < 16; ++j)
            o[j] = (uint32_t)((v[j / 4] >> (16 * (j % 4))) & 0xFFFF);
        for (int j = 16; j < k; ++j) o[j] = 0;
    }
}

// K 16-bit limbs (uint32 lanes) -> 4x64-bit LE values (k <= 16).
void zkt_unpack16(const uint32_t* limbs, u64* out, size_t n, int k) {
    for (size_t i = 0; i < n; ++i) {
        const uint32_t* l = limbs + (size_t)k * i;
        u64* o = out + 4 * i;
        memset(o, 0, 32);
        for (int j = 0; j < k && j < 16; ++j)
            o[j / 4] |= (u64)(l[j] & 0xFFFF) << (16 * (j % 4));
    }
}

int zkt_mont_struct_size() { return (int)sizeof(Mont); }

}  // extern "C"
