"""The port's ``utils.load_torch_resnet`` against the JAX package's and
against a live torch model, as ``tests/L0/test_torch_interop.py`` checks
the JAX one (its ResNet cases).

torchvision is not installed, so the torchvision-named ResNets (conv1,
bn1, layer{s}.{i}.conv{c}/bn{c}, downsample.0/.1, fc) are built here,
their running statistics randomized so that the statistics' conversion
matters.

- the converted tensors equal ``resnet_params_from_jax(apex_tpu.utils.
  load_torch_resnet(...))`` exactly (ResNet-18 and a Bottleneck
  ResNet-50, the conv and the s2d stems, ``norm_name="SyncBatchNorm"``);
- the port's eval forward on them equals the torch model's within 1e-5
  scale-aware, at the conv and the s2d stems;
- the ``module.`` prefix is stripped; leftover keys, missing keys, an
  unknown arch and an unknown stem raise.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

from apex_tpu.utils import load_torch_resnet as jax_load_torch_resnet
from apex_tpu_torch import models
from apex_tpu_torch.models.resnet import resnet_params_from_jax
from apex_tpu_torch.utils import load_torch_resnet


class _BasicBlock(tnn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(idt + self.bn2(self.conv2(y)))


class _Bottleneck(tnn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        return torch.relu(idt + self.bn3(self.conv3(y)))


class _TorchResNet(tnn.Module):
    """torchvision's module names, width trimmed."""

    def __init__(self, block, sizes, width, num_classes=10):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cin = width
        for s, n in enumerate(sizes, start=1):
            planes = width * 2 ** (s - 1)
            blocks = []
            for i in range(n):
                stride = 2 if (s > 1 and i == 0) else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * (4 if block is _Bottleneck else 1)
            setattr(self, f"layer{s}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def _randomized(model):
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.7, 1.4)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.1, 0.1)
    return model.eval()


@pytest.fixture(scope="module")
def r18():
    torch.manual_seed(0)
    return _randomized(_TorchResNet(_BasicBlock, [2, 2, 2, 2], 16))


@pytest.fixture(scope="module")
def r50():
    torch.manual_seed(1)
    return _randomized(_TorchResNet(_Bottleneck, [3, 4, 6, 3], 8))


def _union(converted):
    return {**converted["params"], **converted["batch_stats"]}


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


@pytest.mark.parametrize("arch,stem,norm_name", [
    ("resnet18", "conv", "BatchNorm"), ("resnet18", "s2d", "BatchNorm"),
    ("resnet18", "conv", "SyncBatchNorm"), ("resnet50", "conv", "BatchNorm")])
def test_equals_the_jax_conversion(r18, r50, arch, stem, norm_name):
    sd = (r18 if arch == "resnet18" else r50).state_dict()
    got = _union(load_torch_resnet(sd, arch, norm_name=norm_name, stem=stem))
    want = resnet_params_from_jax(
        jax_load_torch_resnet(sd, arch, norm_name=norm_name, stem=stem))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("arch,stem", [("resnet18", "conv"),
                                       ("resnet18", "s2d"),
                                       ("resnet50", "conv")])
def test_forward_matches_torch(r18, r50, arch, stem):
    tmodel, width = (r18, 16) if arch == "resnet18" else (r50, 8)
    build = models.ResNet18 if arch == "resnet18" else models.ResNet50
    port = build(num_classes=10, width=width, stem=stem, device="cpu",
                 seed=None)
    port.load_state_dict(_union(load_torch_resnet(tmodel.state_dict(), arch,
                                                  stem=stem)))
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        got = port(torch.from_numpy(x), train=False)
    assert scale_err(got, want) < 1e-5


def test_ddp_module_prefix_stripped(r18):
    sd = r18.state_dict()
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    a = _union(load_torch_resnet(prefixed, "resnet18"))
    b = _union(load_torch_resnet(sd, "resnet18"))
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_wrong_checkpoints_raise(r18, r50):
    with pytest.raises(ValueError, match="wrong arch"):
        load_torch_resnet(r50.state_dict(), "resnet18")      # leftovers
    with pytest.raises(ValueError, match="wrong arch"):
        load_torch_resnet(r18.state_dict(), "resnet34")      # missing
    with pytest.raises(ValueError, match="unknown arch"):
        load_torch_resnet(r18.state_dict(), "resnet99")
    with pytest.raises(ValueError, match="stem must be"):
        load_torch_resnet(r18.state_dict(), "resnet18", stem="patch")
