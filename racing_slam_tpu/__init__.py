"""racing_slam_tpu — a monocular SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
GregVS/Racing-SLAM (a C++/OpenCV/Ceres reference):

- ``ops``      : pure-JAX geometry + matching compute kernels (SE3, projection,
                 batched DLT triangulation, essential matrix + vmapped RANSAC,
                 dense masked feature matching, Schur-complement LM bundle
                 adjustment, Pallas GPU kernels for the hot paths).
- ``slam``     : fixed-capacity SoA pytree world state (frames / map points /
                 observations) and the host-side pipeline orchestrator
                 (two-view init, per-frame tracking, keyframing, culling).
- ``models``   : learned feature frontend (SuperPoint-style extractor,
                 LightGlue-style attention matcher).
- ``parallel`` : device-mesh sharding; landmark-sharded distributed bundle
                 adjustment via shard_map + psum collectives.
- ``utils``    : video IO, synthetic scene generation, ATE metrics,
                 checkpointing, visualization dumps.

Everything on the device side is statically shaped and jit-compilable; the
host loop only decodes video and drives steps.
"""

__version__ = "0.1.0"
