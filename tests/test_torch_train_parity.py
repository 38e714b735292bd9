"""The port's training loss and gradients against the reference's.

For reduced qwen2-1.5b, mamba2-1.3b, recurrentgemma-2b,
moonshot-v1-16b-a3b (MoE: the aux loss), whisper-tiny (encoder-decoder)
and internvl2-2b (VLM: text positions only) in float32, the reference's
parameters carried across by ``from_jax_params`` (zero-initialised
leaves and an untied ``lm_head`` perturbed) and numpy-seeded batches
with some targets < 0 (masked): ``forward_train``'s loss, aux loss and
``ppl_proxy`` match ``jax.value_and_grad(forward_train)`` to rtol 2e-6,
and every leaf's gradient matches the reference's, carried through the
same mapping (fused leaves side by side), to 5e-5 of that leaf's max
|gradient| (fp32 on both sides; the summation orders of the matmuls,
softmaxes and scans differ, and the reference's attention runs its
chunked online softmax).  On the CPU the port's kernel wrappers run
their plain versions, so mamba2 trains here through the sequential SSD.

``remat`` recomputes each superblock in the backward pass and changes
no number: the loss and every gradient equal the run without it, bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.models.convert import from_jax_params, named_leaves
from repro_torch.training.train_step import loss_and_grads
from test_torch_archs import ONE_HOT_FLOAT, _perturbed_params

ARCHS = ["qwen2-1.5b", "mamba2-1.3b", "recurrentgemma-2b",
         "moonshot-v1-16b-a3b", "whisper-tiny", "internvl2-2b"]
LOSS_RTOL = 2e-6
GRAD_TOL = 5e-5  # of the leaf's max |gradient|


def train_batch(cfg, B, S, seed):
    """Tokens and targets (every seventh target −1) and the family's
    frames or image embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    targets = tokens[:, 1:].copy()
    targets[:, ::7] = -1
    batch = {"tokens": tokens[:, :-1], "targets": targets}
    if cfg.vlm is not None:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def reference_loss_and_grads(jcfg, params_np, batch):
    jparams = jax.tree.map(jnp.asarray, params_np)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JM.forward_train(jcfg, p, jbatch), has_aux=True)(jparams)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def assert_grads_close(cfg, grads, jgrads):
    want = dict(named_leaves(from_jax_params(cfg, jgrads, device="cpu")))
    assert set(grads) == set(want)
    for path, g in grads.items():
        w = want[path]
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


@ONE_HOT_FLOAT
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_reference(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params_np = _perturbed_params(jcfg, seed=3)
    batch = train_batch(cfg, 2, 24, seed=4)
    jloss, jmetrics, jgrads = reference_loss_and_grads(jcfg, params_np, batch)

    params = from_jax_params(cfg, params_np, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = loss_and_grads(api.make_forward_loss(cfg), params,
                                          tbatch)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    for key in ("loss", "ppl_proxy"):
        assert float(metrics[key]) == pytest.approx(jmetrics[key],
                                                    rel=LOSS_RTOL)
    assert float(metrics["aux_loss"]) == pytest.approx(
        jmetrics["aux_loss"], rel=LOSS_RTOL, abs=1e-7)
    if cfg.moe is not None:
        assert float(metrics["aux_loss"]) > 0
    assert_grads_close(cfg, grads, jgrads)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_remat_changes_no_number(arch):
    cfg = get_config(arch).reduced()
    params = from_jax_params(cfg, _perturbed_params(jax_config(arch).reduced()),
                             device="cpu")
    tbatch = {k: torch.from_numpy(v)
              for k, v in train_batch(cfg, 2, 16, seed=5).items()}
    runs = [loss_and_grads(api.make_forward_loss(cfg, remat=r), params,
                           tbatch) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for path, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][path]), path
