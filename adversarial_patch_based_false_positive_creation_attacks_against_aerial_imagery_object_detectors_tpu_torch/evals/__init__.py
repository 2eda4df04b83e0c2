from .detect import Detector, detections_to_label_rows
from .serving import DetectionService, ServiceStats
