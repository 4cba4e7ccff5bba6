"""The async host pipeline's two card contracts, and B3's dk against an
f64 twin.

* The steady-state step and the metrics pack run under
  ``torch.cuda.set_sync_debug_mode("error")``: the host batch's copy, the
  step's dispatch and the pack never wait for the card, so dispatch can
  run ahead of it (the counterpart of JAX's
  ``jax.transfer_guard("disallow")`` test in
  ``tests/test_async_pipeline.py``).  The packed host copy is read after,
  outside the guarded region.
* A pinned host copy started behind a long kernel and read through
  ``HostMetricsPacker.unpack`` holds the values the card computed (read
  before its event completes, it would hold whatever was there).
* B3's dk at [48, 1024, 128], the inputs ``utils/flash_ab`` draws, against
  twins that all round dS through bf16 as the kernel does
  (``utils/flash_ab.f64_record``).  The f32 and f64 twins agree within
  the card tolerance.  At the element ROADMAP Queue C 2 names, the kernel
  sits 1.38x the tolerance from the f64 twin; moving the twin's P and dP
  by a few f32 ulps (the size of the kernel's own accumulation order and
  ``ex2.approx``) flips one dS rounding there and moves the element by
  the same amount.  So the gap is dS's bf16 rounding, not a fault in the
  kernel's arithmetic, and no element of the kernel's dk is further from
  the exact f64 dk than the f32 twin's.

These need an NVIDIA card and skip without one.  Run them there with
``python -m pytest --noconftest tests/test_torch_async_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.step import HostMetricsPacker, \
    StepMetrics
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

pytestmark = pytest.mark.torchport

# Flash-eligible and small: D = 64, T = 128, 4 nodes x 2 sequences.
SMALL = dict(n_layer=2, n_embd=128, n_head=2, vocab_size=512,
             n_positions=128, seq_len=128, attn_impl="flash")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("attacked", [False, True])
def test_steady_state_step_and_pack_do_not_sync(cuda, attacked):
    trainer = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                       learning_rate=1e-3, detector_warmup=2, remat=True),
        model_overrides=dict(SMALL), device="cuda")
    trainer.initialize()
    if attacked:
        attacker = AdversarialAttacker(AttackConfig(
            attack_types=["gradient_poisoning"], target_nodes=[2],
            intensity=1.0, start_step=0))
        attacker.activate_attacks()
        trainer.set_attack_plan(attacker.plan(4))
    batches = list(get_dataloader("openwebtext", batch_size=8, seq_len=128,
                                  vocab_size=512, num_examples=48))
    state = trainer.state
    packer = None
    for batch in batches[:3]:           # warm: allocator, constants, libs
        state, metrics = trainer._train_step(
            state, trainer._node_batch(batch), trainer.attack_plan)
        packer = HostMetricsPacker(metrics, state.fleet_raw_streak)
        packer.unpack(packer.pack(metrics, state.fleet_raw_streak))
    torch.cuda.synchronize()
    packed = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        # The mode sees a blocking host-to-device copy, which a constant
        # built with torch.tensor inside the step would be.
        with pytest.raises(RuntimeError):
            torch.tensor(0.9, device=cuda)
        for batch in batches[3:]:
            node_batch = trainer._node_batch(batch)
            state, metrics = trainer._train_step(state, node_batch,
                                                 trainer.attack_plan)
            packed.append(packer.pack(metrics, state.fleet_raw_streak))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    trainer.state = state
    host = [packer.unpack(p)[0] for p in packed]
    assert len(host) == 3 and all(np.isfinite(h.loss) for h in host)
    if attacked:
        assert host[-1].weights[2] == 0.0


def test_pinned_drain_after_a_long_kernel_holds_the_card_values(cuda):
    """The copy is queued behind ~100 ms of products; ``unpack`` waits for
    its event, so the host reads what the card wrote."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(4096, 4096, device=cuda, generator=gen)
    template = StepMetrics(*[torch.zeros(4, device=cuda)
                             for _ in StepMetrics._fields[:17]])
    packer = HostMetricsPacker(template)
    torch.cuda.synchronize()
    x = a
    for _ in range(40):
        x = torch.tanh(x @ a) * 0.5
    rows = x[:17, :4]
    metrics = StepMetrics(*[rows[i] for i in range(17)])
    packed = packer.pack(metrics)
    host, _ = packer.unpack(packed)
    want = rows.cpu().numpy()
    for i, name in enumerate(StepMetrics._fields[:17]):
        np.testing.assert_array_equal(getattr(host, name), want[i],
                                      err_msg=name)
    assert packed.host.is_pinned()


def test_flash_bwd_dk_against_f64_twins(cuda):
    """The dk element ROADMAP Queue C 2 names, settled (module
    docstring); errors are over the card tolerance, atol 2e-3 + rtol
    2^-7."""
    from trustworthy_dl_tpu_torch.utils import flash_ab

    record = flash_ab.f64_record()
    print(record)
    assert record["twin32_vs_twin64_over_tolerance"] <= 1.0, record
    # The kernel's gap from the f64 twin at that element is one that
    # ulp-sized moves of P and dP also make, to within the bf16 rounding
    # of the kernel's output.
    at = record["values_at_element"]
    out_ulp = 2.0 ** -8 * abs(at["kernel"]) / (
        2e-3 + 2.0 ** -7 * abs(at["twin64"]))
    moved = max(max(v) for v in
                record["perturbed_vs_twin64_at_element"].values())
    assert record["kernel_vs_twin64_at_element"] <= moved + out_ulp, record
    assert record["kernel_vs_exact64_over_tolerance"] <= \
        record["twin32_vs_exact64_over_tolerance"], record
