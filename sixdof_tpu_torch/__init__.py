"""sixdof_tpu_torch — the pose server of `sixdof_tpu`, ported to PyTorch and CUDA.

A second package beside the JAX one, written for one NVIDIA H100.  It holds
its own copy of every module the pose path needs (it imports nothing of
`sixdof_tpu` and no JAX):

  device.py   device resolution, fp32 geometry precision, bf16 autocast
  ops/        geometry, lie maps, rotation grid, depth filters, rasterizer,
              crop warps, point-to-plane ICP
  kernels/    wrappers around the hand-written CUDA kernels (csrc/), each
              with its plain PyTorch version beside it
  models/     RefineNet / ScoreNetMultiPair (nn.Module), weight conversion,
              the predictors
  io/         PNG decoding, mesh IO, the demo-scene reader
  estimater.py  FoundationPose: register (frame 0) and track_one (later frames)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
