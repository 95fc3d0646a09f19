"""The check sees a broken timed path: each cell driven on the CPU at a tiny
size (the harness's look for a card skipped), with one fault planted in the
program underneath, must come out not correct.  And the control: the
program at a lower kernel tier on the card, at a size a test run holds."""

import pytest
import torch

from portbench.tests.tiny import tiny_run

CELLS = ["frame-eval-h5"]


def _alter_first(real, by, share=0.0):
    """``real``'s per-sample errors with the first ``share`` of the samples
    (at least one) off by ``by`` metres."""

    def altered(pred, target, *a, **k):
        out = real(pred, target, *a, **k).clone()
        flat = out.view(-1)
        flat[: max(1, int(share * flat.numel()))] += by
        return out

    return altered


def _plant(monkeypatch, steps, fault):
    """Plant ``fault`` in the eval step's module (``train/steps.py``)."""
    if fault == "state_unchanged":            # DDIM returns its start unchanged
        monkeypatch.setattr(steps, "ddim_sample", lambda fn, x, *a, **k: x)
    elif fault == "half_batch":               # the second half of each batch is not denoised
        real = steps.ddim_sample

        def half(fn, x, *a, **k):
            out = real(fn, x, *a, **k)
            h = x.shape[0] // 2
            return torch.cat([out[:h], x[h:]])

        monkeypatch.setattr(steps, "ddim_sample", half)
    elif fault == "answer_altered":           # one sample's P1 off by 1 mm where it is made
        monkeypatch.setattr(steps, "mpjpe_per_sample", _alter_first(steps.mpjpe_per_sample, 1e-3))
    elif fault == "p2_altered":               # 2% of the P-MPJPE answers (at least one) off by 1 cm
        monkeypatch.setattr(steps, "p_mpjpe_per_sample",
                            _alter_first(steps.p_mpjpe_per_sample, 1e-2, share=0.02))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "p2_altered"])
def test_eval_fault_is_caught(monkeypatch, cell, fault):
    import diffpose_tpu_torch.train.steps as steps

    _plant(monkeypatch, steps, fault)
    assert tiny_run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(cell):
    assert tiny_run(cell)["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(card, cell):
    """The program at one TF32 pass (``--kernel_precision default``) fails the
    check that the parity grade passes, on the card at a size a test holds."""
    assert tiny_run(cell, device="cuda")["correct"] is True
    assert tiny_run(cell, device="cuda", control="default")["correct"] is False
