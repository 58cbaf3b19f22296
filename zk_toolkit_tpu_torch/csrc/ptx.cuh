// One-instruction PTX carry primitives for field.cuh.
//
// Each function is one `asm volatile` statement. PTX carries a single
// condition-code flag (CC) from an instruction with `.cc` to the next
// `addc`/`subc`/`madc`; only `.cc` instructions write it, so the ordinary
// instructions the compiler places between two links of a chain (moves,
// address arithmetic, selects) leave it alone. `asm volatile` statements
// keep their order, and the compiler itself emits `.cc` instructions only
// for 128-bit integers, which this code never uses. So a chain written as a
// run of these calls reaches ptxas as one unbroken chain; ptxas maps CC to
// predicate registers and keeps the dependency.
//
// Naming: `_cc` sets CC from the carry (or borrow) out; a leading `c`
// (addc, subc, madc) takes CC in. mad_lo: lo(a*b) + c; mad_hi: hi(a*b) + c.
#pragma once

#include <cstdint>

namespace zkt {
namespace ptx {

#define ZKT_PTX2(name, op)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {         \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));             \
    return r;                                                               \
  }
#define ZKT_PTX3(name, op)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,          \
                                           uint32_t c) {                    \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                               \
  }

ZKT_PTX2(add_cc, "add.cc.u32")
ZKT_PTX2(addc_cc, "addc.cc.u32")
ZKT_PTX2(addc, "addc.u32")
ZKT_PTX2(sub_cc, "sub.cc.u32")
ZKT_PTX2(subc_cc, "subc.cc.u32")
ZKT_PTX2(subc, "subc.u32")
ZKT_PTX3(mad_lo_cc, "mad.lo.cc.u32")
ZKT_PTX3(madc_lo_cc, "madc.lo.cc.u32")
ZKT_PTX3(madc_hi_cc, "madc.hi.cc.u32")
ZKT_PTX3(madc_hi, "madc.hi.u32")

#undef ZKT_PTX2
#undef ZKT_PTX3

}  // namespace ptx
}  // namespace zkt
