// The conv encoder in one kernel per tile of frames, forward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) as fused_encoder_apply (line 561) reaches it for an encoder:
// CoordConv, three k3 s2 p1 convs with ELU, the 1×1 projection, the
// residual blocks and the linear head, with every intermediate activation
// on chip. JAX cuts the stack in two segments at act3 to keep each
// backward's VMEM in budget; here one launch covers the whole stack, since
// only a slice of one layer's weights is resident at a time
// (fused_encoder.cuh): a packing launch, then the forward. HBM sees the
// frames, the packed weights once per block (from L2) and the [N, out]
// embedding.
#include "fused_encoder.cuh"

extern "C" {

// Sizes of the kernels' device-memory scratch for `d`: sizes[0] and [1] the
// floats a frame of the backward's activation and cotangent records, [2]
// the weight-gradient floats (all tensors back to back, torch layout), [3]
// the frame chunks of the weight-gradient pass, [4] the floats of the
// backward's packed weights (the forward's, then the transposed slices),
// [5] the floats of the forward's alone. Returns 0, or -1 where the plan
// does not fit (too many layers, or a block's shared memory).
int fused_encoder_sizes(fenc::EncDims d, long long* sizes) {
  fenc::Plan P;
  if (!fenc::make_plan(d, &P)) return -1;
  long long grads = 0;
  for (int l = 0; l < P.n; ++l) {
    const fenc::Layer& L = P.L[l];
    grads += (long long)L.Co * (L.Ci * L.k * L.k + 1);
  }
  sizes[0] = P.stash;
  sizes[1] = P.dstash;
  sizes[2] = grads;
  sizes[3] = (d.N + d.chunk - 1) / d.chunk;
  sizes[4] = P.packed + P.bpacked;
  sizes[5] = P.packed;
  return 0;
}

// Launch on `stream`: frames x [N, H, W, C0] → out [N, out_dim].
// `weights` is a host array of the n_weights device pointers of
// ops/kernels/fused_conv.py::encoder_weights; `coords` the [H + W]
// CoordConv values; `packed` scratch of sizes[5] floats (16-byte aligned);
// all tensors f32 and contiguous. Returns the cudaError_t of the launches
// (0 on success).
int fused_encoder_forward(const void* const* weights, int n_weights, const float* x,
                          const float* coords, float* packed, float* out, fenc::EncDims d,
                          void* stream) {
  fenc::Plan P;
  if (!fenc::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fenc::launch_forward(mrssm::weight_ptrs(weights, n_weights), P, x, coords, packed,
                                   out, nullptr, d.N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
