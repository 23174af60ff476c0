"""The port on the card: each affinity kernel against its plain PyTorch
version on the same card inputs (bit for bit, no tolerance), the main path
through the kernels against the same path through the plain versions on
the CPU, and the flash-attention kernel against its plain version within
the tolerances of ``tests/test_kernels.py`` (float32 2e-5, bfloat16
5e-2).  Every test here needs an NVIDIA GPU and skips without one; the
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch built for CUDA."""
import pytest
import torch

import chip_smoke
from repro_torch.kernels import flash_attention as fa
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_equals_its_plain_version_on_the_card(card, case,
                                                              dtype):
    """Ragged lengths, Sq != Skv, GQA ratios 1, 2, 4, head dims 64, 128,
    256, window 1 and a window past the sequence; each launch counted."""
    B, Sq, Skv, H, K, hd, causal, window = case
    q, k, v = chip_smoke.flash_inputs(B, Sq, Skv, H, K, hd, dtype, seed=Sq)
    before = fa.FLASH_ATTENTION_KERNEL.launches
    err = chip_smoke.compare_flash(q, k, v, causal, window)
    assert err <= chip_smoke.FLASH_TOL[dtype]
    assert fa.FLASH_ATTENTION_KERNEL.launches == before + 1


def test_flash_attention_refuses_an_unsupported_head_dim_on_the_card(card):
    q = torch.zeros((1, 8, 2, 96), device="cuda")
    with pytest.raises(ValueError, match="head_dim 96"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
