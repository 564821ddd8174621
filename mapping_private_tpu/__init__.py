"""mapping_private_tpu — a JAX-native point-cloud mapping & perception engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
TUM-IAS `mapping-private` ROS stack (tabletop perception, RANSAC shape
fitting, ICP registration, C3-HLAC/GRSD voxel features, subspace object
detection, Hough segmentation, semantic table memory), built
accelerator-first:

- dense struct-of-array point/voxel tensors resident in device memory
  (replaces `sensor_msgs::PointCloud` named channels),
- batched grid-hash neighbor gathers (replaces `cloud_kdtree::KdTreeANN`),
- vmapped hypothesis RANSAC (replaces serial `sample_consensus` loops),
- jit-compiled pipelines over a host-side DAG (replaces ROS pub/sub),
- `jax.sharding.Mesh` + collectives for multi-chip scaling (replaces
  nothing in the reference — it was single-machine; this is the new
  scaling dimension per BASELINE.json).

Subpackages
-----------
core          typed arrays: PointCloud, VoxelGrid, SE3 poses
io            PCD reader/writer (old COLUMNS and v.5+ FIELDS formats)
ops           kernels: voxel downsample, kNN/radius neighbors, normals,
              clustering, noise removal, region growing, integral tables
fit           vmapped RANSAC/MSAC models + Gauss-Newton/LM refinement
features      C3-HLAC, RSD, GRSD, VOSCH, PFH, 2D HLAC, PCA subspaces, SVM
registration  point-to-plane ICP, scan-to-map, pose-graph optimization
parallel      mesh/sharding helpers, distributed Gauss-Newton
pipeline      typed config, DAG runner, TableMemory world model
models        end-user detectors: table detector, sliding-box detector,
              Hough segmentation, object classification
utils         profiling, metrics, checkpointing
"""

__version__ = "0.1.0"

# Metric geometry needs exact f32 products: a reduced-precision matmul
# (TF32 on a GPU, bf16 passes elsewhere) keeps ~3 decimal digits, and a
# ~1e-3 absolute error poisons pose composition (4×4), Rodrigues terms
# (W@W), GN systems and near-tie NN ranking — a millimetre floor under
# ICP convergence.  "highest" means true f32.  Hot paths that can
# tolerate less opt back in explicitly with precision=DEFAULT at the
# call site.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
