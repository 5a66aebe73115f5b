"""CNN layer workloads for the paper's benchmark models (conv layers); the
port's own copy of ``repro.perfmodel.workloads``.

Per layer: (name, MACs, weight params, output activations) — standard
published shapes.  Per-layer activation densities follow the paper's
narrative (dense early layers, sparse late layers; Table 3 reports the
weighted averages: AlexNet 3.8/8, VGG-16 3.1/8, MobileNetV1 4.8/8,
ResNet50 3.49/8) and weight DBB is tuned per model (Table 3: 4/8 for
AlexNet/MobileNet/ResNet50-variant, 3/8 for VGG-16).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    macs: float  # multiply-accumulates (dense)
    params: float  # weights
    out_act: float  # output activation elements
    a_density: float  # post-DAP activation density (NNZ_a/8)
    w_density: float  # W-DBB density (NNZ_w/8)


def _mk(name, macs, params, out_act, a_d, w_d):
    return ConvLayer(name, macs, params, out_act, a_d, w_d)


# AlexNet conv1-5 (ImageNet, 227x227): standard MAC/param counts.
# Activation densities: early layers dense (8/8), late layers sparse
# (2-3/8), weighted average ~3.8/8 (Table 3); SparTen wins on conv3-5
# (very sparse), loses on conv1-2 (Fig. 12).
ALEXNET: List[ConvLayer] = [
    _mk("conv1", 105e6, 34.8e3, 290.4e3, 8 / 8, 8 / 8),  # first layer excluded
    _mk("conv2", 223.9e6, 307.2e3, 186.6e3, 4 / 8, 4 / 8),
    _mk("conv3", 149.5e6, 884.7e3, 64.9e3, 2 / 8, 4 / 8),
    _mk("conv4", 112.1e6, 663.5e3, 64.9e3, 2 / 8, 4 / 8),
    _mk("conv5", 74.8e6, 442.4e3, 43.3e3, 2 / 8, 4 / 8),
]

# VGG-16 conv layers; avg act density 3.1/8, W-DBB 3/8 (Table 3).
_VGG = [
    ("conv1_1", 86.7e6, 1.7e3, 3.2e6, 8 / 8, 8 / 8),
    ("conv1_2", 1849.7e6, 36.9e3, 3.2e6, 4 / 8, 3 / 8),
    ("conv2_1", 924.8e6, 73.7e3, 1.6e6, 4 / 8, 3 / 8),
    ("conv2_2", 1849.7e6, 147.5e3, 1.6e6, 3 / 8, 3 / 8),
    ("conv3_1", 924.8e6, 294.9e3, 802e3, 3 / 8, 3 / 8),
    ("conv3_2", 1849.7e6, 589.8e3, 802e3, 2 / 8, 3 / 8),
    ("conv3_3", 1849.7e6, 589.8e3, 802e3, 2 / 8, 3 / 8),
    ("conv4_1", 924.8e6, 1.18e6, 401e3, 2 / 8, 3 / 8),
    ("conv4_2", 1849.7e6, 2.36e6, 401e3, 2 / 8, 3 / 8),
    ("conv4_3", 1849.7e6, 2.36e6, 401e3, 2 / 8, 3 / 8),
    ("conv5_1", 462.4e6, 2.36e6, 100e3, 2 / 8, 3 / 8),
    ("conv5_2", 462.4e6, 2.36e6, 100e3, 2 / 8, 3 / 8),
    ("conv5_3", 462.4e6, 2.36e6, 100e3, 2 / 8, 3 / 8),
]
VGG16 = [_mk(*l) for l in _VGG]

# MobileNetV1 (224x224): depthwise+pointwise pairs; avg act 4.8/8, W 4/8.
# Pointwise layers dominate MACs; DW layers are memory bound (paper §8.4).
_MBN = []
_chw = [
    ("pw1", 25.4e6, 2.0e3, 401e3, 8 / 8, 8 / 8),
    ("pw2", 51.4e6, 8.2e3, 802e3, 6 / 8, 4 / 8),
    ("pw3", 102.8e6, 16.4e3, 401e3, 5 / 8, 4 / 8),
    ("pw4", 51.4e6, 32.8e3, 401e3, 4 / 8, 4 / 8),
    ("pw5", 102.8e6, 65.5e3, 200e3, 4 / 8, 4 / 8),
    ("pw6", 51.4e6, 131.1e3, 200e3, 3 / 8, 4 / 8),
    ("pw7-12", 6 * 102.8e6, 6 * 262.1e3, 6 * 100e3, 2 / 8, 4 / 8),
    ("pw13", 51.4e6, 524.3e3, 50e3, 2 / 8, 4 / 8),
    ("pw14", 102.8e6, 1.05e6, 50e3, 2 / 8, 4 / 8),
]
MOBILENETV1 = [_mk(*l) for l in _chw]

# ResNet50-v1: stage-grouped totals; avg act 3.49/8, W 3/8 (Table 3 *).
_RSN = [
    ("conv1", 118.0e6, 9.4e3, 802e3, 8 / 8, 8 / 8),
    ("stage1", 679.9e6, 215.8e3, 2.4e6, 5 / 8, 3 / 8),
    ("stage2", 1033.7e6, 1.22e6, 1.2e6, 3 / 8, 3 / 8),
    ("stage3", 1465.7e6, 7.1e6, 601e3, 2 / 8, 3 / 8),
    ("stage4", 803.2e6, 14.9e6, 200e3, 2 / 8, 3 / 8),
]
RESNET50 = [_mk(*l) for l in _RSN]

MODELS = {
    "alexnet": ALEXNET,
    "vgg16": VGG16,
    "mobilenetv1": MOBILENETV1,
    "resnet50": RESNET50,
}


def typical_conv(w_density=4 / 8, a_density=3 / 8) -> ConvLayer:
    """The paper's 'typical convolution layer' micro-benchmark subject
    (50% weight, 62.5% activation sparsity in Fig. 10)."""
    return _mk("typical", 1849.7e6, 2.36e6, 401e3, a_density, w_density)
