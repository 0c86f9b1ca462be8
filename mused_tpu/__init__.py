"""mused_tpu — multimodal unsupervised streaming event detection in JAX.

A from-scratch JAX/XLA re-design of the capabilities of kelaendi/mused
(blueprint in SURVEY.md): streaming multimodal kNN-affinity fusion,
sliding-window Frequent-Directions sketching, device clustering,
cross-window cluster matching, and an experiment sweep driver — built for
SPMD execution over accelerator device meshes.

Layer map (mirrors SURVEY.md §1):
  serving.py push-based online detector (production surface, label-free)
  engine/    streaming + batch pipelines (jitted window step)
  ops/       device algorithms: affinity, fusion, FD/SWFD sketch, SVD,
             kmeans, dbscan, matching
  parallel/  mesh construction, sketch merge collectives, sharded steps
  data/      SED2012 ingest, modality featurization, synthetic streams
  utils/     metrics, output, tee logging, checkpointing, config
"""

__version__ = "0.1.0"

from mused_tpu.utils.config import PipelineConfig  # noqa: F401
