"""``repro_torch.batch`` — many graphs per call: size-bucketed stacking
(``GraphBatch``) and the batched MIS-2, coloring, coarsening and AMG-setup
drivers behind ``rt.mis2_batch`` / ``color_batch`` / ``coarsen_batch`` /
``amg_setup_batch``."""
from .container import GraphBatch, GraphBucket, as_graph_batch, bucket_shape

__all__ = ["GraphBatch", "GraphBucket", "as_graph_batch", "bucket_shape"]
