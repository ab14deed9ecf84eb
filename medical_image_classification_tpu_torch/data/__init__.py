from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)
from medical_image_classification_tpu_torch.data.loader import SyntheticLoader
