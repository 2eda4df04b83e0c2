from .detect import Detector, detections_to_label_rows
from .metrics import (
    instance_count, conf_sum, instances_per_class,
    m1_average_instances_created, m2_average_confidence_created,
    m4_per_class_gap, precision_recall, ap_from_pr, average_precision,
    mean_average_precision, creation_metrics_report,
)
from .plotting import draw_detections, class_color
from .serving import DetectionService, ServiceStats
