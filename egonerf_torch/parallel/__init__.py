"""Data parallelism over ``torch.distributed`` (counterpart of
``egonerf_tpu/parallel``)."""
from .mesh import (DATA_AXIS, DataMesh, backend_for, check_batch, grads_of, init_from_env,
                   is_lead_process, launched, make_mesh, pad_to_multiple, process_count,
                   process_index, rank_device)

__all__ = ["DATA_AXIS", "DataMesh", "backend_for", "check_batch", "grads_of", "init_from_env",
           "is_lead_process", "launched", "make_mesh", "pad_to_multiple", "process_count",
           "process_index", "rank_device"]
