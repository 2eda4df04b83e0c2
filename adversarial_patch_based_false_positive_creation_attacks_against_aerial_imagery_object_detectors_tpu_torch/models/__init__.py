from .darknet_cfg import (
    parse_darknet_cfg, write_darknet_cfg, yolov3_blocks, tiny_test_blocks,
    DOTA_ANCHORS, DOTA_NUM_CLASSES,
)
from .darknet import (
    Darknet, Network, build_network, network_from_cfg, init_params, fold_bn,
    apply, conv_specs, last_routes, head_strides, describe_network,
)
from .weights import load_darknet_weights, save_darknet_weights, params_from_jax
