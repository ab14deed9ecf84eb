"""Data, sequence and tensor parallelism: the mesh of process groups, the
collectives with their gradients, the L-sharded scans and the layout of
the tensor-parallel layers' parameters."""

from medical_image_classification_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    init_process_group,
    make_mesh,
    set_current_mesh,
)
from medical_image_classification_tpu_torch.parallel.sequence_parallel import (
    selective_scan_sequence_parallel,
    ssd_sequence_parallel,
)
