"""A family is files the harness finds by name: ``bench/reference/
<family>.py`` (the layout, the layer kinds, the plain forward) and
``bench/families/<family>.py`` (the port's ``ModelConfig``, the model
FLOPs, the tests' cut).  Qwen2's and Mamba-2's layouts, weights' bits
and model FLOPs are held to the values they had when each harness module
still named its two families; a third family runs from new files alone;
a model may mix layer kinds; and no harness module outside a family's
own files names a family."""
import ast
import hashlib
import importlib
import json
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

import bench.families
import bench.reference
from bench import control, families, reference, serve, train, weights
from bench import run as runmod
from bench.tests import tiny
from bench.tests.test_bench_faults import altered_token, limits

BENCH = Path(__file__).resolve().parents[1]

# sha256 of the canonical JSON of weights.leaves ([path, shape, rule]) and
# of weights.spec ([name, path, [[start, stop, step] | index, ...]]), and
# their lengths, of every variant of the full-size configuration files.
LAYOUTS = {
    "qwen2-0.5b": ("e9e8b1e21a0bb2d6163f50a18512746502e2c7ee25d5e13947b83e029804cf94", 194,
                   "28375fd1ad9fdd347c2aa267d40a2c4bf3e01745b5ddd8a1a25e0f3a53854368", 290),
    "qwen2-1.5b": ("6f4cc41e1a9af2333c88c05a59bff98551e14bc6da05c9f1c3e7eabe035909c8", 226,
                   "4436aa9416630743f2439e3dfc59f3536aa5b932e5338cc642ca91c8b987c689", 338),
    "qwen2-7b": ("99f1c10ace4b069f5121b998282f5755255db239dd2e56c3e9703f9579763794", 227,
                 "ef480b498e6d160db65a71a2df8ce371698df64176f9002c7a19f7624240f078", 339),
    "mamba2-370m": ("8c387a78bcef800af72373c373b108e2ca0811201e98528aae7b27d3d5165e63", 434,
                    "27cc0407ae65fe01a7f195f67a07e4eae52575226abd9a2bd1f5c1df48f32d35", 818),
    "mamba2-1.3b": ("6691a1b066b8b988e2d135fbdc89f477f5c7e49bad90a6b8b365c578e32765ca", 434,
                    "2111905207a2a94a754c7ae81356589cfb37a753d65bc022e5b5c910735e03fc", 818),
    "mamba2-2.7b": ("0cd46ca3a2f830dd9f2c8519f32f0bb7ec176c6de05e251cfe316a7a2914e448", 578,
                    "1142264b85dbf0cab224c4b48d963b62bc174cb7045227d1970267d1167f666d", 1090),
}

# sha256 of the flat buffer weights.make draws on the CPU at seed 17 for
# variant i of tiny.config(family), in each type.
FLAT = {
    ("qwen2", 0, "bfloat16"): "4ccb8dda68a5b7610737d922cf1ab6a9a6cce7f9b239f74520671c4678bc14f7",
    ("qwen2", 0, "float32"): "cd411f4ae9b5d4322a68d1b45110551789b0ff5f3f66b570968751dc7abc8c91",
    ("qwen2", 1, "bfloat16"): "8cdc640cc4174359c52dee51c7734a0bd8cff9323a57ab87a04ddb638ce96463",
    ("qwen2", 1, "float32"): "c8aa0903829308ff0b9b633cfb6ed951e73c8f389507ef662b7d4747dd3d273f",
    ("qwen2", 2, "bfloat16"): "6339a26d6019eab834a5c505972fb3341157672636b5a00efa3707a6352ee320",
    ("qwen2", 2, "float32"): "3d625e5055b91d7e1010437272133fddafbc5c29632d747d1fa053446e41c6de",
    ("mamba2", 0, "bfloat16"): "4bc9667ff38c2e8be4ee133250fd0b029b9a425d039fc47f63ecc6794797f8a9",
    ("mamba2", 0, "float32"): "146f20b9faf738257d51492fa5a5cb312cdec63674a8a4a0054a07dadcdad57d",
    ("mamba2", 1, "bfloat16"): "70a4475e1e55e997f74678b617b7b9c81dcd039f27ff18b35163a99f0646bcb3",
    ("mamba2", 1, "float32"): "009f5381cb208f8395cc68d8491874182eba7e70667a03eaf4186a94659e980c",
    ("mamba2", 2, "bfloat16"): "2fc9a9d94c955cee77bcc7ac542742e6125bf538cda604850749747afcbda850",
    ("mamba2", 2, "float32"): "86da25ea6678fce3f4289792c9f98471f970d4ce8322f93ae1e7f15ba8511339",
}

# Model FLOPs of one training step of the training cells' variants.
FLOPS = {("qwen2", "qwen2-1.5b", 4, 1024): 39021711458304.0,
         ("mamba2", "mamba2-1.3b", 2, 1024): 16511888523264.0}


def sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def index_json(idx):
    return [[s.start, s.stop, s.step] if isinstance(s, slice) else s
            for s in idx]


def full_variant(name):
    family = name.split("-")[0]
    cfg = tiny.load("configs", f"{family}-pool")
    return family, cfg, next(v for v in cfg["variants"] if v["name"] == name)


def flat_bytes(tree) -> bytes:
    """The bytes of the one buffer every program leaf views."""
    storage = weights.get(tree, "embed").untyped_storage()
    return torch.empty(0, dtype=torch.uint8).set_(storage).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_are_unchanged(name):
    family, cfg, v = full_variant(name)
    drawn = [[p, list(s), r] for p, s, r in
             weights.leaves(family, v, cfg["init"])]
    spec = [[n, p, index_json(i)] for n, p, i in weights.spec(family, v)]
    assert (sha(drawn), len(drawn), sha(spec), len(spec)) == LAYOUTS[name]


@pytest.mark.parametrize("family,index,dtype", sorted(FLAT))
def test_weights_bits_are_unchanged(family, index, dtype):
    cfg = tiny.config(family)
    tree, _ = weights.make(family, cfg["variants"][index], cfg["init"], 17,
                           index, getattr(torch, dtype), "cpu")
    assert hashlib.sha256(flat_bytes(tree)).hexdigest() == \
        FLAT[family, index, dtype]


@pytest.mark.parametrize("family,name,B,S", sorted(FLOPS))
def test_train_step_flops_are_unchanged(family, name, B, S):
    _, _, v = full_variant(name)
    assert families.load(family).train_step_flops(v, B, S) == \
        FLOPS[family, name, B, S]


# ----------------------------------------------------------------------
# Families from new files alone
# ----------------------------------------------------------------------
TOY_REFERENCE = '''
"""Qwen2's reference under another name."""
from .qwen2 import (embed, head, layer, layer_kinds, leaves,  # noqa: F401
                    logits, spec)
'''

TOY_FAMILY = '''
"""Qwen2's program side under another name."""
from .qwen2 import model_config, tiny, train_step_flops  # noqa: F401
'''

# Layers alternate Qwen2's attention layer and Mamba-2's SSD layer.
MIXED_REFERENCE = '''
"""Attention and SSD layers in turn."""
import torch

from . import mamba2, qwen2
from .common import exact_fp32, mm, model_leaves, model_spec

KINDS = {"attn": qwen2, "ssd": mamba2}
embed, head = qwen2.embed, qwen2.head


def layer_kinds(v):
    return [("attn", "ssd")[i % 2] for i in range(v["num_hidden_layers"])]


def of(v, i):
    return KINDS[layer_kinds(v)[i]]


def leaves(v, init):
    return model_leaves(v, init, lambda v, init, i:
                        of(v, i).layer_leaves(v, init, i))


def spec(v):
    return model_spec(v, lambda v, i: of(v, i).layer_spec(v, i))


def layer(v, W, i, x, positions, mm=mm):
    return of(v, i).layer(v, W, i, x, positions, mm)


@torch.no_grad()
def logits(v, W, tokens, last, mm=mm):
    with exact_fp32():
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed(W, tokens)
        for i in range(v["num_hidden_layers"]):
            x = layer(v, W, i, x, positions, mm)
        return head(v, W, x[:, -last:], mm)
'''


@pytest.fixture
def new_families(tmp_path, monkeypatch):
    """``toyfam`` and ``mixfam``, visible only through the two packages'
    search paths."""
    ref, fam = tmp_path / "reference", tmp_path / "families"
    ref.mkdir()
    fam.mkdir()
    (ref / "toyfam.py").write_text(TOY_REFERENCE)
    (fam / "toyfam.py").write_text(TOY_FAMILY)
    (ref / "mixfam.py").write_text(MIXED_REFERENCE)
    monkeypatch.setattr(bench.reference, "__path__",
                        [*bench.reference.__path__, str(ref)])
    monkeypatch.setattr(bench.families, "__path__",
                        [*bench.families.__path__, str(fam)])
    importlib.invalidate_caches()
    yield
    for name in ("bench.reference.toyfam", "bench.families.toyfam",
                 "bench.reference.mixfam"):
        sys.modules.pop(name, None)


def toy_config() -> dict:
    cfg = tiny.config("qwen2")
    cfg.update(name="toyfam-pool", family="toyfam")
    return cfg


@pytest.mark.parametrize("fault", [None, altered_token])
def test_a_new_family_serves_from_files_alone(new_families, fault):
    cell = "qwen2-pool.serve"
    ctx = serve.run({"name": "toyfam-pool.serve"}, toy_config(),
                    tiny.serve_traffic(), limits(cell), 17, 0.5, False, "cpu",
                    time.time(), fault=fault)
    assert ctx["correct"] is (fault is None), ctx["checks"]


@pytest.mark.parametrize("fault", [None, control.frozen_state])
def test_a_new_family_trains_from_files_alone(new_families, fault):
    cfg = toy_config()
    cfg["train_variant"] = cfg["variants"][0]["name"]
    cell = "qwen2-pool.train"
    ctx = train.run({"name": "toyfam-pool.train"}, cfg, tiny.train_traffic(
        "train-b4s1024"), limits(cell), 19, 0.2, False, "cpu", time.time(),
        fault=fault)
    assert ctx["correct"] is (fault is None), ctx["checks"]
    if fault is None:   # and its mfu reads through its own module
        assert runmod.reader("mfu.train.dense")(ctx) > 0


def test_a_new_family_draws_the_bits_of_the_one_it_delegates_to(
        new_families):
    cfg = tiny.config("qwen2")
    v = cfg["variants"][1]
    a, _ = weights.make("qwen2", v, cfg["init"], 17, 1, torch.float32, "cpu")
    b, _ = weights.make("toyfam", v, cfg["init"], 17, 1, torch.float32,
                        "cpu")
    assert flat_bytes(a) == flat_bytes(b)


def mixed_variant():
    q, m = tiny.config("qwen2"), tiny.config("mamba2")
    v = dict(q["variants"][1], ssm=m["variants"][1]["ssm"],
             num_hidden_layers=4, name="mix")
    return v, {**m["init"], **q["init"]}


def element_ids(t, total):
    """The flat buffer's element indices that view ``t`` covers."""
    return torch.arange(total).as_strided(t.shape, t.stride(),
                                          t.storage_offset()).flatten()


def test_a_model_may_mix_layer_kinds(new_families):
    v, init = mixed_variant()
    assert reference.load("mixfam").layer_kinds(v) == \
        ["attn", "ssd", "attn", "ssd"]
    drawn = weights.leaves("mixfam", v, init)
    assert [p for p, _, _ in drawn if p.startswith("layers/1/")][1] == \
        "layers/1/ssd/w_in"
    tree, W = weights.make("mixfam", v, init, 5, 0, torch.float32, "cpu")
    flat = weights.get(tree, "embed")
    total = flat.untyped_storage().nbytes() // flat.element_size()
    assert total == sum(t.numel() for _, t in
                        ((p, weights.get(tree, p)) for p, _, _ in drawn))
    ptr = flat.untyped_storage().data_ptr()
    # every program leaf and every logical leaf views the one buffer;
    # the program leaves tile it, and no two logical leaves share an element
    hits = torch.zeros(total, dtype=torch.int64)
    for p, shape, _ in drawn:
        t = weights.get(tree, p)
        assert t.untyped_storage().data_ptr() == ptr and t.shape == shape
        hits[element_ids(t, total)] += 1
    assert bool((hits == 1).all())
    hits.zero_()
    for name, t in W.items():
        assert t.untyped_storage().data_ptr() == ptr, name
        hits[element_ids(t, total)] += 1
    assert int(hits.max()) == 1
    pad = (weights.get(tree, "embed").shape[0] - v["vocab_size"]) \
        * v["hidden_size"]
    assert int(hits.sum()) == total - pad
    # the logical leaves round-trip through the program tree and its paths
    by_path = {p: weights.get(tree, p) for p, _, _ in drawn}
    for again in (weights.logical("mixfam", v, tree),
                  weights.logical_of_paths("mixfam", v, by_path)):
        assert list(again) == list(W)
        for k, t in again.items():
            assert (t.data_ptr(), t.shape, t.stride()) == \
                (W[k].data_ptr(), W[k].shape, W[k].stride()), k
    # and the one layer signature runs both kinds in one forward
    toks = torch.randint(0, v["vocab_size"], (1, 20),
                         generator=torch.Generator().manual_seed(0))
    lg = reference.load("mixfam").logits(v, W, toks, 2)
    assert lg.shape == (1, 2, v["vocab_size"]) \
        and bool(torch.isfinite(lg).all())


class _Trace:
    def kernel_seconds(self, pattern):
        return 1e-3


@pytest.mark.parametrize("metric,kind", [("k2bwd_roofline.train", "attn"),
                                         ("k4bwd_roofline.train", "ssd")])
def test_kernel_readers_count_the_layers_of_their_kind(new_families, metric,
                                                       kind):
    read = runmod.reader(metric)
    v, _ = mixed_variant()
    traffic = dict(tiny.train_traffic(), param_dtype="float32")

    def ctx(family, layers):
        return dict(trace=_Trace(), variant=dict(v, num_hidden_layers=layers),
                    traced_steps=2, traffic=traffic,
                    config={"family": family})
    whole = {"attn": "qwen2", "ssd": "mamba2"}[kind]
    other = {"attn": "mamba2", "ssd": "qwen2"}[kind]
    # 4 mixed layers hold 2 of the kind: the reading of 2 whole layers
    assert read(ctx("mixfam", 4)) == read(ctx(whole, 2)) > 0
    assert read(ctx(other, 4)) is None


def test_an_unknown_family_names_its_missing_file():
    with pytest.raises(ValueError, match=r"bench/reference/nofam\.py"):
        reference.load("nofam")
    with pytest.raises(ValueError, match=r"bench/families/nofam\.py"):
        families.load("nofam")


# ----------------------------------------------------------------------
# No family name in the harness
# ----------------------------------------------------------------------
def family_names():
    names = {json.loads(p.read_text())["family"]
             for p in (BENCH / "configs").glob("*.json")}
    return names | {p.stem for p in (BENCH / "families").glob("*.py")
                    if p.stem != "__init__"}


def named_families(source: str, names) -> list:
    """Line numbers of string literals equal to a family's name, outside
    docstrings."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.lineno for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value in names and id(n) not in docs]


def test_the_name_check_finds_a_family_compared_or_keyed():
    names = {"qwen2"}
    for src in ('if family == "qwen2":\n    pass\n',
                'REFS = {"qwen2": ref}\n',
                'ok = fam in ("qwen2", "other")\n',
                'def f(c):\n    return c["family"] != "qwen2"\n'):
        assert named_families(src, names), src
    assert not named_families(textwrap.dedent('''
        """qwen2"""
        def f():
            """qwen2"""
            return "qwen2-pool"
        '''), names)


def test_no_harness_module_names_a_family():
    names = family_names()
    assert {"qwen2", "mamba2"} <= names
    own = {BENCH / d / f"{n}.py" for d in ("reference", "families")
           for n in names}
    found = {}
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts or p in own:
            continue
        lines = named_families(p.read_text(), names)
        if lines:
            found[str(p.relative_to(BENCH))] = lines
    assert not found, found
