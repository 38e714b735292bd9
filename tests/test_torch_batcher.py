"""The port's continuous batcher against the reference's
(``repro/serving/batcher.py``): reduced qwen2-1.5b, gemma3-4b,
mamba2-1.3b and moonshot-v1-16b-a3b in float32 on the reference's
parameters (zero-initialised leaves perturbed), the same prompts through both
engines in lockstep, the same tokens after every step, slots reused
mid-run.  Also the slot-reuse and queue-telemetry tests of
``tests/test_batcher.py`` on the port's own ``ProfileStore``.

The reference's batcher runs with 64 cache slots, the reduced window:
with more slots than the window its prefill leaves NaN in gemma3's
local ring for a prompt shorter than half the window, and every logit
of the next decode step is NaN (``tests/test_torch_archs.py``
``test_short_prompt_under_a_local_ring``).  The port runs with 96
slots, so gemma3's local layers use the ring and its global layers a
longer cache: neither changes a value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.serving.batcher import ContinuousBatcher as JaxBatcher
from repro.serving.batcher import GenRequest as JaxRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.profiles import ModelProfile, ProfileStore
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batcher import ContinuousBatcher, GenRequest
from test_torch_ssm import perturbed_params

ONE_HOT_FLOAT = pytest.mark.filterwarnings(
    "ignore:jax.nn.one_hot input should be integer-typed:DeprecationWarning")


def _lockstep(arch, prompts, max_new, *, max_slots=2, cache_len=(64, 96),
              eos_id=None, seed=0):
    """Run both batchers on the same requests, one step at a time, and
    require the same tokens, the same slots and the same queue after
    every step.  Returns the port's engine and requests."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params_np = perturbed_params(jcfg, seed)
    ref = JaxBatcher(jcfg, jax.tree.map(jnp.asarray, params_np),
                     max_slots=max_slots, cache_len=cache_len[0],
                     eos_id=eos_id)
    eng = ContinuousBatcher(cfg, from_jax_params(cfg, params_np,
                                                 device="cpu"),
                            max_slots=max_slots, cache_len=cache_len[1],
                            eos_id=eos_id, device="cpu")
    ref_reqs = [JaxRequest(rid=i, prompt=p, max_new=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
    reqs = [GenRequest(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for a, b in zip(ref_reqs, reqs):
        ref.submit(a)
        eng.submit(b)
    for _ in range(200):
        busy = eng.step()
        assert busy == ref.step()
        assert [r.generated for r in reqs] == [r.generated
                                               for r in ref_reqs]
        assert [r.done for r in reqs] == [r.done for r in ref_reqs]
        assert [s and s.rid for s in eng.slots] == \
            [s and s.rid for s in ref.slots]
        assert eng.queue_depth() == ref.queue_depth()
        if not busy and eng.queue_depth() == 0:
            break
    assert eng.n_steps == ref.n_steps
    assert all(r.done for r in reqs)
    return eng, reqs


@ONE_HOT_FLOAT
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-4b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b"])
def test_batcher_matches_reference_step_by_step(arch):
    rng = np.random.default_rng(1)
    vocab = get_config(arch).reduced().vocab_size
    prompts = [rng.integers(0, vocab, size=n, dtype=np.int32)
               for n in (9, 17, 5, 40, 12)]
    eng, reqs = _lockstep(arch, prompts, (6, 3, 8, 4, 5))
    assert [len(r.generated) for r in reqs] == [6, 3, 8, 4, 5]
    assert len({t for r in reqs for t in r.generated}) > 3


@ONE_HOT_FLOAT
def test_batcher_retires_on_eos_and_a_full_cache_as_the_reference():
    """EOS (the first token request 0 generates) and a cache that fills:
    a 20-token prompt in 24 slots retires at position 23."""
    cfg = get_config("qwen2-1.5b").reduced()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (6, 20, 7)]
    _, reqs = _lockstep("qwen2-1.5b", prompts, (9, 9, 9),
                        cache_len=(24, 24))
    eos = reqs[0].generated[1]
    _, reqs = _lockstep("qwen2-1.5b", prompts, (9, 9, 9),
                        cache_len=(24, 24), eos_id=eos)
    assert reqs[0].generated[-1] == eos and len(reqs[0].generated) < 9
    assert len(reqs[1].generated) == 24 - 1 - 20 + 1


def _port_engine(max_slots, cache_len, **kw):
    cfg = get_config("qwen2-1.5b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    return ContinuousBatcher(cfg, params, max_slots=max_slots,
                             cache_len=cache_len, device="cpu", **kw)


def test_slots_reused_and_throughput_counted():
    rng = np.random.default_rng(1)
    engine = _port_engine(2, 64)
    for i in range(5):
        engine.submit(GenRequest(
            rid=i, prompt=rng.integers(0, 100, size=6, dtype=np.int32),
            max_new=3))
    engine.run_to_completion()
    assert engine.n_steps > 0
    assert all(not s for s in engine.slots)


def test_queue_telemetry_feeds_profile_store():
    """Queue waits observed at slot insertion flow into the port's
    profile store's W_queue estimate (the queue-aware routing signal)."""
    store = ProfileStore([ModelProfile(name="qwen", accuracy=0.9)])
    rng = np.random.default_rng(2)
    engine = _port_engine(1, 64, store=store, model_name="qwen")
    for i in range(3):  # 1 slot + 3 requests => real queueing
        engine.submit(GenRequest(
            rid=i, prompt=rng.integers(0, 100, size=6, dtype=np.int32),
            max_new=3))
    assert engine.queue_depth() == 3
    engine.run_to_completion()
    assert engine.queue_depth() == 0
    assert store["qwen"].queue_obs == 3
    assert store.queue_wait("qwen") > 0.0
    tel = engine.telemetry()
    assert tel["model"] == "qwen" and tel["queue_depth"] == 0


def test_batcher_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(cfg, None)
