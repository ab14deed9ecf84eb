"""The evaluation tools: the metric suite (``metrics``) and Grad-CAM
(``gradcam``; OpenCV is imported only by ``overlay_heatmap``)."""
from medical_image_classification_tpu_torch.evaluate.gradcam import (
    grad_cam,
    overlay_heatmap,
)
from medical_image_classification_tpu_torch.evaluate.metrics import (
    classification_metrics,
    confusion_matrix,
    count_parameters,
    metrics_to_csv,
    roc_auc_ovr,
)
