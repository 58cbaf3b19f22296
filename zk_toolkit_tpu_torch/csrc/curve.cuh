// Jacobian group law on y^2 = x^3 + b (a = 0) over the field primitives of
// field.cuh, shared by point_add.cu (B2) and point_double.cu (B3). Each
// formula is the one in ops/curve_ops.py, field operation for field
// operation (a square is mont_sq, which equals mont_mul(a, a)), so the
// output limbs equal the plain version's.
#pragma once

#include "field.cuh"

namespace zkt {

// dbl-2009-l. Y = 0 or Z = 0 gives Z3 = 0 with no case analysis. Ordered so
// that at most five field elements are live besides a product's scratch.
// Outputs may alias inputs.
template <int N>
__device__ __forceinline__ void jac_double(uint32_t x3[N], uint32_t y3[N],
                                           uint32_t z3[N], const uint32_t x[N],
                                           const uint32_t y[N],
                                           const uint32_t z[N],
                                           const Modulus<N>& M) {
  uint32_t zo[N], a[N], b[N], c[N], t[N];
  mont_mul<N>(zo, y, z, M);
  dbl<N>(zo, zo, M);                       // z3 = 2*y*z
  mont_sq<N>(b, y, M);                     // b = y^2
  mont_sq<N>(a, x, M);                     // a = x^2
  add<N>(t, x, b, M);
  mont_sq<N>(c, b, M);                     // c = b^2
  mont_sq<N>(t, t, M);                     // g = (x + b)^2
  sub<N>(t, t, a, M);
  sub<N>(t, t, c, M);
  dbl<N>(t, t, M);                         // d = 2(g - a - c)
  dbl<N>(b, a, M);
  add<N>(b, b, a, M);                      // e = 3a
  mont_sq<N>(a, b, M);                     // f = e^2
  dbl<N>(x3, t, M);
  sub<N>(x3, a, x3, M);                    // x3 = f - 2d
  dbl<N>(c, c, M);
  dbl<N>(c, c, M);
  dbl<N>(c, c, M);                         // c8 = 8c
  sub<N>(t, t, x3, M);
  mont_mul<N>(t, b, t, M);
  sub<N>(y3, t, c, M);                     // y3 = e(d - x3) - 8c
  copy<N>(z3, zo);
}

}  // namespace zkt
