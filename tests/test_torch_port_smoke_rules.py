"""chip_smoke.py's rule for a small training step against another one
(`small_step_errors`), on the CPU with made-up losses and gradients: a loss
within atol 1e-4 + rtol 1e-3 and a gradient within 1e-3 relative norm, or,
given the CPU's step at one thread and at this process's count
(`cpu_steps`), within twice their difference. No fixed tolerance moves with
that spread (or, given several CPU pairs, twice the largest of their
differences). And its rule for one output of the card against the CPU
(`small_output_check`).
"""

import pytest
import torch

import chip_smoke

W = ("w",)


def step(loss, grad, other=1.0):
    return {"loss": loss}, {"w": torch.tensor([grad, other], dtype=torch.float64)}


REF = step(2.0, 0.0)  # |grad| = 1: an error e in the first entry is a relative norm e


@pytest.mark.parametrize("grad_err,loss_err,ok", [(5e-4, 1e-4, True), (2e-3, 0.0, False), (0.0, 2.2e-3, False),
                                                  (0.0, 2.0e-3, True)])
def test_fixed_tolerances_without_noise(grad_err, loss_err, ok):
    got = step(2.0 + loss_err, grad_err)
    if ok:
        loss, grad = chip_smoke.small_step_errors("rule", got, REF, W)
        assert loss["loss"] == pytest.approx(loss_err) and grad["w"] == pytest.approx(grad_err)
    else:
        with pytest.raises(AssertionError, match="rule"):
            chip_smoke.small_step_errors("rule", got, REF, W)


@pytest.mark.parametrize("grad_err,ok", [(2.9e-3, True), (3.1e-3, False), (9e-4, True)])
def test_cpu_spread_against_its_own_step(grad_err, ok):
    """The CPU at one thread moves the gradient by 1.5e-3 from the CPU at N
    threads: the card may differ from its reference by up to 3e-3, however
    far the two CPU steps lie from that reference."""
    cpu_n, cpu_1 = step(2.0, 0.0, -1.0), step(2.0, 1.5e-3, -1.0)
    got = step(2.0, grad_err)
    if ok:
        chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=(cpu_1, cpu_n))
    else:
        with pytest.raises(AssertionError, match="the CPU against itself"):
            chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=(cpu_1, cpu_n))


@pytest.mark.parametrize("loss_err,ok", [(7.9e-3, True), (8.1e-3, False)])
def test_loss_within_twice_the_cpu_spread(loss_err, ok):
    """A loss the CPU moves by 4e-3 between its two thread counts may differ
    by up to 8e-3, past its fixed atol 1e-4 + rtol 1e-3 (2.1e-3 here)."""
    cpu_steps = (step(2.0 + 4e-3, 0.0), step(2.0, 0.0))
    got = step(2.0 + loss_err, 0.0)
    if ok:
        chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=cpu_steps)
    else:
        with pytest.raises(AssertionError, match="rule loss"):
            chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=cpu_steps)


@pytest.mark.parametrize("grad_err,ok", [(5.9e-3, True), (6.1e-3, False)])
def test_largest_of_several_cpu_spreads(grad_err, ok):
    """With a list of CPU pairs (train_decoders: 1 thread, and 1 thread from
    ulp-moved images, each against 2 threads), a quantity may differ by
    twice the largest of their differences: here 3e-3, from the second."""
    cpu_n = step(2.0, 0.0, -1.0)
    probes = [(step(2.0, 1e-3, -1.0), cpu_n), (step(2.0, -3e-3, -1.0), cpu_n)]
    got = step(2.0, grad_err)
    if ok:
        chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=probes)
    else:
        with pytest.raises(AssertionError, match="the CPU against itself: 0.003"):
            chip_smoke.small_step_errors("rule", got, REF, W, cpu_steps=probes)


@pytest.mark.parametrize("planted,ok", [(0.0, True), (0.01, False), (-0.01, False)])
def test_train_reference_small_catches_a_motion_gradient_planted_1_percent_off(planted, ok):
    """train_reference_small's rule on the numbers of a card run (H100):
    the motion decoder's gradient 3.76e-4 from the CPU's at 8 threads, the
    CPU's own step at one thread 1.17e-3 from it, so the bound is twice
    that, 2.34e-3. The card's gradient planted 1% high (or low) fails."""
    name = "motion_decoder.conv5.0.weight"
    rng = torch.Generator().manual_seed(0)
    g = torch.randn(4096, generator=rng, dtype=torch.float64)
    direction = torch.randn(4096, generator=rng, dtype=torch.float64)
    direction /= direction.norm()

    def moved(rel):  # g moved by `rel` of its norm, orthogonally to the plant
        return g + rel * g.norm() * direction

    cpu_n = ({"loss": 2.0}, {name: g})
    cpu_1 = ({"loss": 2.0}, {name: moved(1.17e-3)})
    card = ({"loss": 2.0}, {name: moved(3.76e-4) * (1 + planted)})
    if ok:
        _, grad = chip_smoke.small_step_errors("train_reference_small", card, cpu_n, (name,), (cpu_1, cpu_n))
        assert grad[name] == pytest.approx(3.76e-4, rel=1e-6)
    else:
        with pytest.raises(AssertionError, match="train_reference_small grad motion_decoder"):
            chip_smoke.small_step_errors("train_reference_small", card, cpu_n, (name,), (cpu_1, cpu_n))


# chip_smoke.py's card-against-CPU rule for one output (`small_output_check`),
# on made-up (1, 50 queries, 20) logits: 1000 elements, so SMALL_CPU_CROSSED
# lets 10 pass by agreeing with the CPU's result at one thread and
# SMALL_PRED_OUTLIERS lets 1 pass end to end
REF_LOGITS = torch.full((1, 50, 20), 10.0)  # bound atol 1e-4 + rtol 1e-3 * 10 = 1.01e-2


def card(*moved):
    got = REF_LOGITS.clone()
    for q, k, d in moved:
        got[0, q, k] += d
    return got


@pytest.mark.parametrize("moved,ok", [([], True), ([(3, 0, 1.0e-2)], True), ([(3, 0, 1.1e-2)], False)])
def test_output_within_fixed_bound(moved, ok):
    fields, held = chip_smoke.small_output_check(card(*moved), REF_LOGITS, 1e-4, 1e-3)
    assert held == ok and fields["beyond_tolerance"] == (0 if ok else 1) and fields["elements"] == 1000


CPU_1_THREAD = [(3, 0, 0.02), (3, 1, 0.03)] + [(q, 5, 0.02) for q in range(10, 19)]  # 11 elements moved


@pytest.mark.parametrize("moved,matched,ok", [
    ([(3, 0, 0.02), (3, 1, 0.025)], 2, True),  # within the bound of the CPU at one thread
    ([(3, 0, 0.035)], 0, False),  # past the bound of both CPU results
    ([(4, 0, 0.012)], 0, False),  # where the CPU at one thread agrees with itself at N
    (CPU_1_THREAD, 11, False),  # 11 of 1000 elements agree only with the one-thread result: past SMALL_CPU_CROSSED
])
def test_output_past_bound_agrees_with_the_cpu_at_one_thread(moved, matched, ok):
    """The CPU at one thread moves 11 elements past the bound of its result
    at N threads: an element of the card past that bound passes only within
    the bound of the one-thread result, and at most 10 may."""
    fields, held = chip_smoke.small_output_check(card(*moved), REF_LOGITS, 1e-4, 1e-3, card(*CPU_1_THREAD))
    assert held == ok
    assert fields["cpu_1_thread_beyond_tolerance"] == 11 and fields["passed_against_cpu_1_thread"] == matched


@pytest.mark.parametrize("moved,ok", [([(7, 2, 0.04)], True), ([(7, 2, 0.06)], False),
                                      ([(7, 2, 0.02), (8, 2, 0.02)], False)])
def test_end_to_end_outliers(moved, ok):
    """pred_*: one element of 1000 (SMALL_PRED_OUTLIERS) may lie past the
    bound, within SMALL_PRED_MAX_ERR."""
    _, held = chip_smoke.small_output_check(card(*moved), REF_LOGITS, 1e-4, 1e-3, REF_LOGITS, outliers=True)
    assert held == ok
