from . import assets
from .assets import (
    load_class_names, load_anchor_groups, load_printable_colors,
    ANCHOR_FILE, DOTA_NAMES_FILE, PRINTABLE_COLORS_FILE,
)
from .dataset import (load_image_rgb, pad_and_scale, DotaDataset,
    BatchLoader, DeviceStore, SyntheticData, epoch_plan)
from .labels import (read_label_file, write_label_file, pad_labels,
    count_instances, filter_min_box_scale)
