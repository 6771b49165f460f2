// The in-kernel form of a block-sparse mask spec (repro_torch/masks/spec.py),
// shared by the masked forward (flash_fwd.cu) and the masked backward
// (flash_bwd.cu).
//
// The host lowers a spec to a postfix program of at most 16 instructions
// (kernels/flash_fwd.py::mask_program): one instruction per atom --
// FULL, CAUSAL, WINDOW w, PREFIX n, SINK n, DOC, DOC_CAUSAL -- and AND / OR
// for the combinators. The program travels by value in the kernel's
// arguments, so a new mask needs no new build, and every thread of a CTA
// runs the same instructions (no divergence). DOC and DOC_CAUSAL compare the
// spec's token_info (segment ids), an int32 array of S entries on the card.
//
// visible(q, k) is MaskSpec.mask_fn at absolute positions (q, k): the
// kernels evaluate it per element on PARTIAL tiles only, and a masked lane
// contributes an exact zero.
#pragma once

namespace dash_mask {

constexpr int MAX_PROGRAM = 16;
enum Op : int {
  OP_FULL = 0,
  OP_CAUSAL = 1,
  OP_WINDOW = 2,
  OP_PREFIX = 3,
  OP_SINK = 4,
  OP_DOC = 5,
  OP_DOC_CAUSAL = 6,
  OP_AND = 7,
  OP_OR = 8,
};

struct Program {
  int n;                 // instructions (0: no mask program)
  int op[MAX_PROGRAM];
  int arg[MAX_PROGRAM];
  const int* info;       // token_info on the card, or nullptr
};

// From the host array [n, op_0, arg_0, op_1, arg_1, ...]; nullptr or a
// malformed program gives n = -1, which the entry points refuse.
inline Program program_from(const int* flat, const void* info) {
  Program p{};
  p.info = static_cast<const int*>(info);
  if (flat == nullptr) return p;
  p.n = flat[0];
  if (p.n <= 0 || p.n > MAX_PROGRAM) {
    p.n = -1;
    return p;
  }
  int depth = 0;
  for (int i = 0; i < p.n; ++i) {
    p.op[i] = flat[1 + 2 * i];
    p.arg[i] = flat[2 + 2 * i];
    const bool binary = p.op[i] == OP_AND || p.op[i] == OP_OR;
    const bool doc = p.op[i] == OP_DOC || p.op[i] == OP_DOC_CAUSAL;
    if (p.op[i] < OP_FULL || p.op[i] > OP_OR || (doc && info == nullptr) ||
        (binary && depth < 2)) {
      p.n = -1;
      return p;
    }
    depth += binary ? -1 : 1;
  }
  if (depth != 1) p.n = -1;
  return p;
}

// mask(q, k) for q, k >= 0; the stack is one bit per entry
__device__ __forceinline__ bool visible(const Program& p, int q, int k) {
  unsigned stack = 0;
  for (int i = 0; i < p.n; ++i) {
    const int a = p.arg[i];
    unsigned v;
    switch (p.op[i]) {
      case OP_CAUSAL: v = q >= k; break;
      case OP_WINDOW: v = q >= k && k > q - a; break;
      case OP_PREFIX: v = q >= k || k < a; break;
      case OP_SINK: v = k < a; break;
      case OP_DOC: v = p.info[q] == p.info[k]; break;
      case OP_DOC_CAUSAL: v = p.info[q] == p.info[k] && q >= k; break;
      case OP_AND:
        stack = ((stack >> 2) << 1) | (stack & (stack >> 1) & 1u);
        continue;
      case OP_OR:
        stack = ((stack >> 2) << 1) | ((stack | (stack >> 1)) & 1u);
        continue;
      default: v = 1; break;  // OP_FULL
    }
    stack = (stack << 1) | v;
  }
  return stack & 1u;
}

}  // namespace dash_mask
