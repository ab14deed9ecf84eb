from medical_image_classification_tpu_torch.models.registry import (
    available_models,
    create_model,
)
from medical_image_classification_tpu_torch.models.vssm import VSSM
