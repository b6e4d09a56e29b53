"""LMBN (Lightweight Multi-Branch Network) ReID backbones in PyTorch.

Counterpart of ``boxmot_tpu/models/lmbn.py`` (``LMBN_n`` and
``LMBN_ain_n``), built on the port's OSNet blocks (``models/osnet.py``) as
the JAX file builds them on its OSNet: a trunk shared up to the first
stage-3 block, then three branches (global, partial, channel), each the rest
of the OSNet stages with weights of its own.  The global branch adds an
OSBlock bottleneck (Top-DB-Net's drop block, an identity at inference)
that feeds a max-pooled and an avg-pooled head; the partial branch a
max-pooled head and two horizontal halves; the channel branch splits the
pooled channels in two, each through one shared 1x1 + BN + ReLU to 512.
Each head passes a BNNeck, and the embedding is the seven 512-d features
stacked as (B, 512, 7) and flattened channel first to 3584 columns
(lmbn_n.py:127-133).

The modules carry the Flax modules' names (``global_branch.conv4_0``,
``reduction_3.bn``, ``shared_fc``); inside an OSBlock the port's torchreid
names stand (``conv2b.1`` for Flax's ``conv2_2_1``), which
``models/convert.py`` maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from boxmot_tpu_torch.models.layers import BiasFreeBatchNorm1d
from boxmot_tpu_torch.models.osnet import Conv1x1, ConvLayer, OSBlock

FEAT = 512  # every head's width


class BNNeck3(nn.Module):
    """1x1 reduction (a linear layer, no bias) and a batch norm whose bias is
    frozen at 0 (bnneck.py:49-76)."""

    def __init__(self, cin: int, feat_dim: int = FEAT):
        super().__init__()
        self.reduction = nn.Linear(cin, feat_dim, bias=False)
        self.bn = BiasFreeBatchNorm1d(feat_dim)

    def forward(self, x):
        return self.bn(self.reduction(x))


class BNNeckBN(nn.Module):
    """A batch norm alone, bias frozen at 0 (bnneck.py BNNeck:6-46)."""

    def __init__(self, channels: int = FEAT):
        super().__init__()
        self.bn = BiasFreeBatchNorm1d(channels)

    def forward(self, x):
        return self.bn(x)


class _Branch(nn.Module):
    """conv3[1:] + transition + conv4 + conv5 with weights of its own."""

    def __init__(self, c3: int, c4: int, kinds):
        super().__init__()
        self.conv3_1 = OSBlock(c3, c3, in_inside=kinds[0] == "in")
        self.transition3 = Conv1x1(c3, c3)
        self.conv4_0 = OSBlock(c3, c4, in_inside=kinds[1] == "in")
        self.conv4_1 = OSBlock(c4, c4, in_inside=kinds[2] == "in")
        self.conv5 = Conv1x1(c4, c4)

    def forward(self, x):
        x = F.avg_pool2d(self.transition3(self.conv3_1(x)), 2, 2)
        return self.conv5(self.conv4_1(self.conv4_0(x)))


class LMBN(nn.Module):
    """``ain`` False: LMBN_n (an osnet_x1_0 trunk); True: LMBN_ain_n (the
    osnet_ain_x1_0 trunk: an instance-norm stem and OSBlockINin blocks)."""

    def __init__(self, ain: bool = False, channels=(64, 256, 384, 512)):
        super().__init__()
        self.feature_dim = 7 * FEAT
        c0, c1, c2, c3 = channels
        # AIN block kinds (osnet_ain.py:511-527): stage 2 in, in; the
        # branches' conv3_1, conv4_0, conv4_1 in, in, os; plain LMBN os
        s2 = ("in", "in") if ain else ("os", "os")
        kinds = ("in", "in", "os") if ain else ("os", "os", "os")
        self.conv1 = ConvLayer(3, c0, 7, stride=2, IN=ain)
        self.conv2_0 = OSBlock(c0, c1, in_inside=s2[0] == "in")
        self.conv2_1 = OSBlock(c1, c1, in_inside=s2[1] == "in")
        self.transition2 = Conv1x1(c1, c1)
        self.conv3_0 = OSBlock(c1, c2)
        self.global_branch = _Branch(c2, c3, kinds)
        self.partial_branch = _Branch(c2, c3, kinds)
        self.channel_branch = _Branch(c2, c3, kinds)
        self.drop_bottleneck = OSBlock(c3, FEAT)
        for i in range(5):
            setattr(self, f"reduction_{i}", BNNeck3(c3))
        self.shared_fc = nn.Linear(c3 // 2, FEAT, bias=False)
        self.shared_bn = nn.BatchNorm1d(FEAT)
        self.reduction_ch_0 = BNNeckBN()
        self.reduction_ch_1 = BNNeckBN()

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.transition2(self.conv2_1(self.conv2_0(x)))
        x = self.conv3_0(F.avg_pool2d(x, 2, 2))
        glo = self.global_branch(x)
        par = self.partial_branch(x)
        cha = self.channel_branch(x)
        # the drop block is train-only: both global heads read the bottleneck
        glo = self.drop_bottleneck(glo)
        gmax = lambda t: t.amax(dim=(2, 3))  # noqa: E731
        gavg = lambda t: t.mean(dim=(2, 3))  # noqa: E731
        h = par.shape[2]
        f_glo = self.reduction_0(gavg(glo))
        f_p0 = self.reduction_1(gmax(par))
        f_p1 = self.reduction_2(gavg(par[:, :, : h // 2]))
        f_p2 = self.reduction_3(gavg(par[:, :, h // 2:]))
        f_glo_drop = self.reduction_4(gmax(glo))
        c = gavg(cha)
        half = c.shape[1] // 2
        c0 = F.relu(self.shared_bn(self.shared_fc(c[:, :half])))
        c1 = F.relu(self.shared_bn(self.shared_fc(c[:, half:])))
        feats = [f_glo, f_glo_drop, f_p0, f_p1, f_p2, self.reduction_ch_0(c0),
                 self.reduction_ch_1(c1)]
        # stack(dim=2).flatten(1, 2): channel-major interleave (lmbn_n.py:128-132)
        return torch.stack(feats, dim=2).reshape(x.shape[0], -1)


def build_lmbn(name: str) -> LMBN:
    if name == "lmbn_n":
        return LMBN(ain=False)
    if name == "lmbn_ain_n":
        return LMBN(ain=True)
    raise ValueError(f"unknown LMBN variant {name!r}")
