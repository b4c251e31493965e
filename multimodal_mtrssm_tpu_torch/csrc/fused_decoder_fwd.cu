// The conv decoder in one kernel per tile of frames, forward.
//
// Replaces multimodal_mtrssm_tpu/ops/pallas/fused_conv.py::_fwd_kernel
// (line 455) as fused_decoder_apply (line 766) reaches it for a decoder:
// the two linears (the second unflattened in (c, h, w) order), the 1×1
// projection, the residual blocks and the three k4 s2 p1 transposed convs
// (ELU, ELU, Tanh), with every intermediate activation on chip. JAX cuts
// the stack into four segments (the linears and residual stack, then one
// per transposed conv) to keep each backward's VMEM in budget; here one
// launch covers the whole stack, since only a slice of one layer's weights
// is resident at a time (fused_decoder.cuh): a packing launch, then the
// forward. HBM sees the [N, F] features, the packed weights once per block
// (from L2) and the [N, 32, 32, 1] frames.
#include "fused_decoder.cuh"

extern "C" {

// Sizes of the kernels' device-memory scratch for `d`: sizes[0] and [1] the
// floats a frame of the backward's activation and cotangent records, [2]
// the weight-gradient floats (all tensors back to back, torch layout), [3]
// the frame chunks of the weight-gradient pass, [4] the floats of the
// backward's packed weights (the forward's, then the transposed slices),
// [5] the floats of the forward's alone. Returns 0, or -1 where the plan
// does not fit (too many layers, or a block's shared memory).
int fused_decoder_sizes(fdec::DecDims d, long long* sizes) {
  fdec::Plan P;
  if (!fdec::make_plan(d, &P)) return -1;
  long long grads = 0;
  for (int l = 0; l < P.n; ++l) {
    const fdec::Layer& L = P.L[l];
    grads += (long long)L.Co * L.Ci * L.k * L.k + fdec::bias_size(L);
  }
  sizes[0] = P.stash;
  sizes[1] = P.dstash;
  sizes[2] = grads;
  sizes[3] = (d.N + d.chunk - 1) / d.chunk;
  sizes[4] = P.packed + P.bpacked;
  sizes[5] = P.packed;
  return 0;
}

// Launch on `stream`: features [N, F] → out [N, 32, 32, 1]. `weights` is a
// host array of the n_weights device pointers of
// ops/kernels/fused_conv.py::decoder_weights; `packed` scratch of sizes[5]
// floats (16-byte aligned); all tensors f32 and contiguous. Returns the
// cudaError_t of the launches (0 on success).
int fused_decoder_forward(const void* const* weights, int n_weights, const float* feats,
                          float* packed, float* out, fdec::DecDims d, void* stream) {
  fdec::Plan P;
  if (!fdec::make_plan(d, &P) || n_weights != 2 * P.n) return (int)cudaErrorInvalidValue;
  return (int)fdec::launch_forward(mrssm::weight_ptrs(weights, n_weights), P, feats, packed, out,
                                   nullptr, d.N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
