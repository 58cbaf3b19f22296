// Jacobian group law on y^2 = x^3 + b (a = 0) over the field primitives of
// field.cuh, shared by point_add.cu (B2) and point_double.cu (B3). Each
// formula is the one in ops/curve_ops.py, field operation for field
// operation, so the output limbs equal the plain version's.
#pragma once

#include "field.cuh"

namespace zkt {

// dbl-2009-l. Y = 0 or Z = 0 gives Z3 = 0 with no case analysis.
// Outputs may alias inputs.
template <int N>
__device__ __forceinline__ void jac_double(uint32_t x3[N], uint32_t y3[N],
                                           uint32_t z3[N], const uint32_t x[N],
                                           const uint32_t y[N],
                                           const uint32_t z[N],
                                           const Modulus<N>& M) {
  uint32_t a[N], b[N], c[N], d[N], e[N], t[N], zo[N];
  mont_mul<N>(zo, y, z, M);
  dbl<N>(zo, zo, M);                       // z3 = 2*y*z
  mont_mul<N>(a, x, x, M);                 // a = x^2
  mont_mul<N>(b, y, y, M);                 // b = y^2
  dbl<N>(e, a, M);
  add<N>(e, e, a, M);                      // e = 3a
  mont_mul<N>(c, b, b, M);                 // c = b^2
  add<N>(t, x, b, M);
  mont_mul<N>(t, t, t, M);                 // g = (x + b)^2
  sub<N>(t, t, a, M);
  sub<N>(t, t, c, M);
  dbl<N>(d, t, M);                         // d = 2(g - a - c)
  mont_mul<N>(t, e, e, M);                 // f = e^2
  dbl<N>(a, d, M);
  sub<N>(x3, t, a, M);                     // x3 = f - 2d
  dbl<N>(c, c, M);
  dbl<N>(c, c, M);
  dbl<N>(c, c, M);                         // c8 = 8c
  sub<N>(t, d, x3, M);
  mont_mul<N>(t, e, t, M);
  sub<N>(y3, t, c, M);                     // y3 = e(d - x3) - 8c
  copy<N>(z3, zo);
}

}  // namespace zkt
