"""MLFN (Multi-Level Factorisation Net) ReID backbone in PyTorch.

Counterpart of ``boxmot_tpu/models/mlfn.py`` (``MLFNBlock``, ``MLFN``): a
ResNeXt-style trunk of 16 factor-module blocks whose grouped 3x3
convolutions (32 groups) are gated group by group by a factor-selection
module (FSM): channel ``c = g * n + i`` of the block's middle width gets
gate ``s[g]`` (mlfn.py:76-82), which in NCHW is ``repeat_interleave`` of
the gates over dim 1.  The embedding averages a projection of the final
map's pooled features with a projection of all 16 FSM signatures.  The
modules carry the Flax modules' names (``block4.fsm_conv2``,
``fc_s_bn``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _spec(ch):
    """(out, stride, FSM widths) of each of the 16 blocks (mlfn.py:125-147)."""
    return ([(ch[1], 1, (128, 64))] * 3
            + [(ch[2], 2, (256, 128))]
            + [(ch[2], 1, (256, 128))] * 3
            + [(ch[3], 2, (512, 128))]
            + [(ch[3], 1, (512, 128))] * 5
            + [(ch[4], 2, (512, 128))]
            + [(ch[4], 1, (512, 128))] * 2)


class MLFNBlock(nn.Module):
    def __init__(self, cin: int, out: int, stride: int, fsm, groups: int = 32):
        super().__init__()
        mid = out // 2
        self.groups = groups
        self.fsm_conv1, self.fsm_bn1 = nn.Conv2d(cin, fsm[0], 1), nn.BatchNorm2d(fsm[0])
        self.fsm_conv2, self.fsm_bn2 = nn.Conv2d(fsm[0], fsm[1], 1), nn.BatchNorm2d(fsm[1])
        self.fsm_conv3, self.fsm_bn3 = nn.Conv2d(fsm[1], groups, 1), nn.BatchNorm2d(groups)
        self.fm_conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.fm_bn1 = nn.BatchNorm2d(mid)
        self.fm_conv2 = nn.Conv2d(mid, mid, 3, stride, 1, groups=groups, bias=False)
        self.fm_bn2 = nn.BatchNorm2d(mid)
        self.fm_conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.fm_bn3 = nn.BatchNorm2d(out)
        self.project = cin != out or stride > 1
        if self.project:
            self.down_conv = nn.Conv2d(cin, out, 1, stride, bias=False)
            self.down_bn = nn.BatchNorm2d(out)

    def forward(self, x):
        # factor selection module: GAP -> two 1x1 conv+BN+ReLU -> sigmoid gates
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.fsm_bn1(self.fsm_conv1(s)))
        s = F.relu(self.fsm_bn2(self.fsm_conv2(s)))
        s = torch.sigmoid(self.fsm_bn3(self.fsm_conv3(s)))  # (B, groups, 1, 1)
        y = F.relu(self.fm_bn1(self.fm_conv1(x)))
        y = F.relu(self.fm_bn2(self.fm_conv2(y)))
        y = y * s.repeat_interleave(y.shape[1] // self.groups, dim=1)
        y = F.relu(self.fm_bn3(self.fm_conv3(y)))
        residual = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(residual + y), s


class MLFN(nn.Module):
    def __init__(self, channels=(64, 256, 512, 1024, 2048), embed_dim: int = 1024,
                 groups: int = 32):
        super().__init__()
        ch = channels
        self.feature_dim = embed_dim
        self.conv1 = nn.Conv2d(3, ch[0], 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(ch[0])
        spec = _spec(ch)
        cin = ch[0]
        for i, (out, stride, fsm) in enumerate(spec):
            setattr(self, f"block{i}", MLFNBlock(cin, out, stride, fsm, groups))
            cin = out
        self.n_blocks = len(spec)
        self.fc_x = nn.Linear(ch[4], embed_dim, bias=False)
        self.fc_x_bn = nn.BatchNorm1d(embed_dim)
        self.fc_s = nn.Linear(self.n_blocks * groups, embed_dim, bias=False)
        self.fc_s_bn = nn.BatchNorm1d(embed_dim)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        sigs = []
        for i in range(self.n_blocks):
            x, s = getattr(self, f"block{i}")(x)
            sigs.append(s[:, :, 0, 0])
        s_hat = torch.cat(sigs, dim=1)  # (B, 16 * groups)
        v_x = F.relu(self.fc_x_bn(self.fc_x(x.mean(dim=(2, 3)))))
        v_s = F.relu(self.fc_s_bn(self.fc_s(s_hat)))
        return 0.5 * (v_x + v_s)


def build_mlfn() -> MLFN:
    return MLFN()
