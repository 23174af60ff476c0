"""The port on the card: each CUDA kernel against its plain PyTorch version
on the same card inputs (bit for bit, no tolerance), and the main path
through the kernels against the same path through the plain versions on
the CPU.  Every test here needs an NVIDIA GPU and skips without one; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch built for CUDA."""
import pytest
import torch

import chip_smoke
from repro_torch.kernels.affinity import affinity_valid, bulk_decide
from repro_torch.kernels.affinity.bulk_ref import bulk_decide_ref
from repro_torch.kernels.affinity.ref import affinity_valid_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.parametrize("W,T,R", [(1, 1, 1), (130, 5, 257), (16385, 3, 129),
                                   (16384, 4, 3), (257, 33, 9),
                                   (16384, 512, 512)])
def test_kernels_equal_plain_versions_on_the_card(card, W, T, R):
    ins, (strat, warm) = chip_smoke.on_card(
        chip_smoke.kernel_case(W, T, R, seed=W + T + R))
    assert torch.equal(affinity_valid(*ins), affinity_valid_ref(*ins))
    got = bulk_decide(*ins, strat, warm)
    want = bulk_decide_ref(*ins, strat, warm)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[2], want[2])
    assert int(got[2][0]) == 0  # the all-tied row: lowest index
    if R > 1:
        assert int(got[2][1]) == -1  # the row with no valid worker


def test_main_path_on_the_card_equals_the_plain_versions(card):
    got, _ = chip_smoke.drive_main_path(chip_smoke.build_rig(4096))
    want, _ = chip_smoke.drive_main_path(
        chip_smoke.build_rig(4096, device="cpu"))
    assert got == want
