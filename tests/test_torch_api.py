"""``models/api.py`` against the reference's.

- ``applicable_shapes`` equals the reference's for all ten archs.
- For all ten archs at full width under their applicable shapes,
  ``batch_specs`` and ``decode_input_specs`` give the reference's shapes
  and dtypes (its ``ShapeDtypeStruct``s; the decode cache layer by layer
  from its stacked superblock and tail templates).  Shapes only: nothing
  is allocated on either side.
- ``make_train_batch`` draws a batch of those specs from an explicit
  generator on an explicit device; ``make_prefill_step`` and
  ``make_serve_step`` are ``prefill`` and ``decode_step``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import api
from repro_torch.models import model as M

CASES = [(arch, shape.name) for arch in jreg.ARCH_IDS
         for shape in jreg.applicable_shapes(jreg.get_config(arch))]


def _dtype(d):
    return str(jnp.dtype(d)) if not isinstance(d, torch.dtype) \
        else str(d).removeprefix("torch.")


def test_registry_and_applicable_shapes_match_reference():
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    for arch in jreg.ARCH_IDS:
        got = [s.name for s in registry.applicable_shapes(
            registry.get_config(arch))]
        want = [s.name for s in jreg.applicable_shapes(jreg.get_config(arch))]
        assert got == want, arch
    assert len(CASES) == 33


@pytest.mark.parametrize("arch,shape", CASES)
def test_specs_match_reference(arch, shape):
    jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
    js = jreg.SHAPES[shape]
    sh = ShapeConfig(js.name, js.seq_len, js.global_batch, js.mode)

    want = japi.batch_specs(jcfg, js)
    got = api.batch_specs(cfg, sh)
    assert list(got) == list(want)
    for key, (shp, dt) in got.items():
        assert (shp, _dtype(dt)) == (want[key].shape,
                                     _dtype(want[key].dtype)), key

    want = japi.decode_input_specs(jcfg, js)
    got = api.decode_input_specs(cfg, sh)
    for key in ("tokens", "pos"):
        assert (got[key][0], _dtype(got[key][1])) == (
            want[key].shape, _dtype(want[key].dtype))
    cache, jcache = got["cache"], want["cache"]
    pat = len(cfg.pattern)
    assert len(cache) == cfg.n_layers
    for i, layer in enumerate(cache):
        if i < cfg.n_superblocks * pat:
            ref = {k: (v.shape[1:], v.dtype)
                   for k, v in jcache["blocks"][f"p{i % pat}"].items()}
        else:
            ref = {k: (v.shape, v.dtype) for k, v in jcache["tail"][
                f"t{i - cfg.n_superblocks * pat}"].items()}
        if cfg.block_kinds[i] == "ssd":  # the port's conv is x | B | C
            conv = [ref.pop(c) for c in "xBC"]
            ref["conv"] = (conv[0][0][:-1] + (sum(c[0][-1] for c in conv),),
                           conv[0][1])
        assert {k: (tuple(s), _dtype(d)) for k, (s, d) in layer.items()} \
            == {k: (tuple(s), _dtype(d)) for k, (s, d) in ref.items()}, (
                arch, shape, i)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-tiny",
                                  "internvl2-2b"])
def test_make_train_batch(arch):
    cfg = registry.get_config(arch).reduced()
    shape = ShapeConfig("t", 24, 3, "train")
    gen = torch.Generator().manual_seed(1)
    batch = api.make_train_batch(cfg, shape, gen, device="cpu")
    specs = api.batch_specs(cfg, shape)
    assert list(batch) == list(specs)
    for key, (shp, dt) in specs.items():
        assert batch[key].shape == shp and batch[key].dtype == dt, key
        assert batch[key].device.type == "cpu"
        if dt == torch.int32:
            assert 0 <= int(batch[key].min()) and \
                int(batch[key].max()) < cfg.vocab_size
        else:
            assert 0.015 < float(batch[key].float().std()) < 0.025
    again = api.make_train_batch(cfg, shape,
                                 torch.Generator().manual_seed(1),
                                 device="cpu")
    for key in batch:
        assert torch.equal(batch[key], again[key])
    card_gen = SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="generator lives on cuda:0"):
        api.make_train_batch(cfg, shape, card_gen, device="cpu")


def test_steps_are_prefill_and_decode():
    cfg = registry.get_config("whisper-tiny").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(2)
    batch = api.make_train_batch(cfg, ShapeConfig("p", 12, 2, "prefill"),
                                 gen, device="cpu")
    cache, logits = api.make_prefill_step(cfg, 16)(params, batch)
    want_cache, want = M.prefill(cfg, params, batch, 16)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    tok = torch.argmax(logits, -1)
    pos = torch.full((2,), 12, dtype=torch.int32)
    step, _ = api.make_serve_step(cfg)(params, cache, tok, pos)
    want, _ = M.decode_step(cfg, params, want_cache, tok, pos)
    torch.testing.assert_close(step, want, rtol=0, atol=0)
    assert np.isfinite(step.numpy()).all()
