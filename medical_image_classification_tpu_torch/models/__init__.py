from medical_image_classification_tpu_torch.models.registry import (
    available_fusion_models,
    available_models,
    create_fusion_model,
    create_model,
)
from medical_image_classification_tpu_torch.models.vssm import VSSM
