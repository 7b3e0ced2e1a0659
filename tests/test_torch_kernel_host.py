"""The port's kernels without a GPU (distributed_groth16_tpu_torch/tools/
kernel_host_check.py): csrc/limb_group.cu and csrc/ntt_small.cu built by
g++ with the field core's inline PTX swapped for C++ (an emulated carry
flag), warps and blocks run as host threads with their barriers, each
kernel held limb for limb against its plain PyTorch version: one case per
kernel and group (kernel 2 at ragged widths and on a strided view, kernel
4 at S = 2 ... 256 on ragged column counts). Skips where no g++ 12 or
newer is found."""

import tempfile
from pathlib import Path

import pytest
import torch

from distributed_groth16_tpu_torch.tools import kernel_host_check as khc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_build():
    if khc.gxx() is None:
        pytest.skip("needs g++ 12 or newer (C++20 <barrier>)")
    with tempfile.TemporaryDirectory() as tmp:
        yield khc.build(Path(tmp))


@pytest.mark.parametrize("kernel,group", khc.CASES,
                         ids=[f"{k}_{g}" for k, g in khc.CASES])
def test_host_build_matches_plain_version(host_build, kernel, group):
    assert khc.check(host_build, kernel, group)
