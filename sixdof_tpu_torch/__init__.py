"""sixdof_tpu_torch — the frame loop of `sixdof_tpu`, ported to PyTorch and CUDA.

A second package beside the JAX one, written for one NVIDIA H100.  It holds
its own copy of every module its path needs (it imports nothing of
`sixdof_tpu` and no JAX):

  device.py   device resolution, fp32 geometry precision, bf16 autocast
  ops/        geometry, lie maps, rotation grid, depth filters, rasterizer,
              crop warps, point clouds, batched point-to-plane ICP and the
              capture program, ray-mesh intersection
  kernels/    wrappers around the hand-written CUDA kernels (csrc/), each
              with its plain PyTorch version beside it
  models/     RefineNet / ScoreNetMultiPair (nn.Module) and their flax-style
              initialisation, weight conversion, checkpoints, the predictors
  parallel/   the network trainer: synthetic pairs rendered on the device,
              the sensor model, procedural objects, refiner and scorer steps
  io/         PNG decoding, mesh IO (textured OBJ too), the demo-scene reader
  estimater.py  FoundationPose: register (frame 0) and track_one (later frames)
  app/        the run loop (register -> ICP refine -> defect ray trace, then
              tracking with capture events), the ICP pipeline, defect
              projection
  utils/      colormap, stage timer

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
