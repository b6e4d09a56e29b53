"""The FLOP counter against hand-counted small layers, and the cells' model."""

import torch
from torch import nn

from portbench import flops
from portbench.drivers.live_frames import model_flops
from portbench.tests.conftest import LIVE, small_cell


def test_conv_and_linear_counted_by_hand():
    with torch.device("meta"):
        net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                            nn.Conv2d(8, 8, 3, stride=2, padding=1, groups=4, bias=False),
                            nn.Flatten(), nn.Linear(8 * 8 * 8, 10))
    want = (2 * (8 * 16 * 16) * (3 * 3 * 3)  # the first convolution's outputs x taps
            + 2 * (8 * 8 * 8) * (2 * 3 * 3)  # grouped: 8 / 4 input channels a group
            + 2 * 10 * 512)
    assert flops.conv_linear_flops(net, (1, 3, 16, 16)) == want
    assert flops.conv_linear_flops(net, (3, 3, 16, 16)) == 3 * want


def test_yolox_x_and_osnet_counts():
    """YOLOX-X (one class) at 640 x 640 counts 281.0 GFLOP, its paper's
    281.9 with 80 classes; the live cell adds osnet_x0_25 on 64 crops."""
    from portbench.reference.frozen.models.yolox import build_yolox

    with torch.device("meta"):
        yolox = build_yolox("yolox_x")
    assert abs(flops.conv_linear_flops(yolox, (1, 3, 640, 640)) / 1e9 - 281.0) < 0.1
    cfg = small_cell(LIVE).config
    cfg["detector"].update(name="yolox_x", imgsz=[800, 1440])
    cfg["reid"]["crop_hw"] = [256, 128]
    assert 795e9 < model_flops(cfg) < 806e9
