"""Device kernels on the GPU against their plain references.

The same comparisons chip_smoke.py runs at full width (its phase 3), here
at test sizes.  Marked `gpu`: without a card they skip (the `gpu_device`
fixture decides at run time); on the card `python chip_smoke.py` runs them
with --require-gpu, so there they fail if JAX sees no GPU.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def model():
    from vosk_tpu.utils.benchdata import make_bench_model

    return make_bench_model(num_states=20_000, num_pdfs=512, hidden=512,
                            max_active=512, realistic=True, num_words=2000)


def test_gather_bit_exact(gpu_device):
    chip_smoke.check_gather(B=8, P=6008, E=2800, K=700)


def test_mfcc_matches_numpy(gpu_device, model):
    out = chip_smoke.check_mfcc(model, B=4)
    assert out["max_abs_diff_highest"] <= out["tol"]


def test_am_forward_matches_cpu(gpu_device, model):
    chip_smoke.check_am(model, B=2, frames=60)


def test_token_passing_matches_cpu(gpu_device, model):
    out = chip_smoke.check_token_passing(model, model.shared_decoder())
    assert out["channels"] == 2


def test_v4_matches_ref_decoder(gpu_device):
    assert chip_smoke.check_v4_small()["decodes_matching_reference"] == 16
