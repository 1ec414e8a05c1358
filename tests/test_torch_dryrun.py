"""The port's cell plans, dry-run, op counter and roofline
(``repro_torch.launch.specs`` / ``dryrun``, ``repro_torch.utils.opcount``
/ ``roofline``) against the JAX package's ``repro.launch.specs``,
``repro.utils.hlo`` and ``repro.utils.roofline``.

Every fake process group a test starts is destroyed before the test
ends (``run_cell`` destroys its own; the fixtures here theirs), so no
later test in the worker sees one."""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_supported as jcell_supported
from repro.configs.base import get_config as jget_config
from repro.launch import specs as jspecs
from repro.launch.train import reduced_config as jreduced_config
from repro.models import transformer as jtr
from repro.utils import hlo as jhlo
from repro.utils import roofline as jroofline
from repro_torch.configs.base import SHAPES, cell_supported, get_config
from repro_torch.kernels.flash_attention import (flash_attention_meta,
                                                 flash_cost, kernel_tiles)
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as tr
from repro_torch.models.common import spec_shapes
from repro_torch.sharding import collectives
from repro_torch.utils import opcount, roofline

ARCHS = sorted(["gemma-7b", "qwen1.5-32b", "gemma3-4b", "minicpm3-4b",
                "olmoe-1b-7b", "llama4-scout-17b-a16e", "mamba2-2.7b",
                "hymba-1.5b", "hubert-xlarge", "internvl2-26b"])
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if cell_supported(get_config(a), SHAPES[s])[0]]
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.int8): torch.int8}


def _fake(rank: int, world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


@pytest.fixture
def fake_world():
    """``start(rank, world)`` a fake process group; destroyed after."""
    def start(rank: int, world: int) -> None:
        _fake(rank, world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# -- cell_supported, GRAD_ACCUM --------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_matches_the_reference(arch):
    for name in SHAPES:
        assert cell_supported(get_config(arch), SHAPES[name]) == \
            jcell_supported(jget_config(arch), JSHAPES[name])


def test_the_support_matrix_and_grad_accum():
    ok = [cell_supported(get_config(a), SHAPES[s])[0]
          for a in ARCHS for s in SHAPES]
    assert (len(ok), sum(ok), len(ok) - sum(ok)) == (40, 32, 8)
    assert specs.GRAD_ACCUM == jspecs.GRAD_ACCUM


# -- the plans against the reference's build_cell at a (1, 1) mesh ---------


@pytest.fixture
def one_rank():
    """A (1, 1) ``DeviceMesh`` on a fake process group of one rank (the
    reference's ``jax.make_mesh((1, 1), ...)``), and the reference's."""
    _fake(0, 1)
    try:
        yield (make_local_mesh(1, 1, device_type="cpu"),
               jax.make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_plan_matches_the_reference(one_rank, arch, shape):
    mesh, jmesh = one_rank
    plan = specs.build_cell(arch, shape, mesh)
    ref = jspecs.build_cell(arch, shape, jmesh)
    assert plan.meta == ref.meta
    got = list(_leaves(plan.args))
    want = list(_leaves(ref.args))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, sd) in zip(got, want):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(sd.shape), path
        assert t.dtype == _DTYPES[jnp.dtype(sd.dtype)], path
    # a (1, 1) rank holds every block whole
    blocks = list(_leaves(plan.local_args({"data": 0, "model": 0})))
    assert [tuple(t.shape) for _, t in blocks] == \
        [tuple(t.shape) for _, t in got]


@pytest.mark.parametrize("multi_pod,accum", [(False, 16), (True, 8)])
def test_accumulation_clamp_on_the_production_mesh(fake_world, multi_pod,
                                                   accum):
    """Qwen1.5-32B's train_4k: 16 microbatches of 16 rows on 16 data
    ranks; over 2 pods × 16 the batch covers 32 ranks, so 8."""
    fake_world(0, 512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    plan = specs.build_cell("qwen1.5-32b", "train_4k", mesh)
    assert plan.meta["grad_accum"] == accum
    tokens = plan.args[1]["tokens"]
    assert tuple(tokens.shape) == (accum, 256 // accum, 4096)
    local = plan.local_args()[1]["tokens"]
    assert tuple(local.shape) == (accum, 256 // accum // (
        32 if multi_pod else 16), 4096)


# -- the counter: the counterparts of tests/test_hlo.py -------------------


def test_a_loop_counts_each_trip(fake_world):
    """Five products and five all-reduces over {2, 3} of a world of 4:
    5× the FLOPs and bytes and five collectives (executions, not sites);
    the group crosses a block of 3 ranks and no block of 2."""
    fake_world(2, 4)
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")

    def loop(x, w):
        for _ in range(5):
            x = collectives.all_reduce(x @ w, groups[1])
        return x

    for stride, crosses in ((2, False), (3, True)):
        rec = opcount.count(loop, x, w, stride=stride)
        assert rec.flops == 2 * 8 * 16 * 16 * 5
        assert rec.collective_bytes["all-reduce"] == 8 * 16 * 4 * 5
        assert rec.n_collectives["all-reduce"] == 5
        assert rec.collective_dcn_bytes == (8 * 16 * 4 * 5 if crosses
                                            else 0)


def test_crosses_as_the_reference():
    for stride in (2, 3):
        assert opcount.crosses([0, 1], stride) is False
        assert opcount.crosses([2, 3], stride) == (stride == 3)


def test_dtype_byte_table():
    names = {torch.float64: "f64", torch.float32: "f32",
             torch.float16: "f16", torch.bfloat16: "bf16",
             torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
             torch.int64: "s64", torch.uint64: "u64", torch.int32: "s32",
             torch.uint32: "u32", torch.int16: "s16", torch.uint16: "u16",
             torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
             torch.complex64: "c64", torch.complex128: "c128"}
    assert set(names) == set(opcount.DTYPE_BYTES)
    for dt, name in names.items():
        assert opcount.DTYPE_BYTES[dt] == jhlo._DTYPE_BYTES[name]
        assert opcount.DTYPE_BYTES[dt] == torch.empty(
            (), dtype=dt).element_size()


def test_products_and_convolutions_match_flop_counter():
    """FLOPs as ``torch.utils.flop_counter`` counts them, forward and
    backward, on meta; views count no bytes, copies a read and a
    write."""
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=gen, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=gen, requires_grad=True)
    wt = torch.randn(3, 5, 3, 3, generator=gen, requires_grad=True)
    a = torch.randn(5, 7, generator=gen, requires_grad=True)
    b = torch.randn(7, 6, generator=gen, requires_grad=True)
    bias = torch.randn(6, generator=gen)

    def f(x, w, wt, a, b, bias):
        y = torch.nn.functional.conv2d(x, w, padding=1)
        z = torch.nn.functional.conv_transpose2d(x, wt, stride=2)
        m = torch.addmm(bias, a, b) + torch.einsum(
            "bij,bjk->bik", a[None].expand(3, 5, 7),
            b[None].expand(3, 7, 6)).sum(0)
        loss = y.sum() + z.sum() + m.sum()
        return torch.autograd.grad(loss, [x, w, wt, a, b])

    with FlopCounterMode(display=False) as fc:
        f(x, w, wt, a, b, bias)
    rec = opcount.count(f, *(t.detach().to("meta").requires_grad_()
                             for t in (x, w, wt, a, b)), bias.to("meta"))
    assert rec.flops == fc.get_total_flops()
    by_op = {str(k).split(".")[-1]: v
             for k, v in fc.get_flop_counts()["Global"].items()}
    for name, n in by_op.items():
        assert rec.ops[name]["flops"] == n, name

    t = torch.empty(64, 32, device="meta")
    views = opcount.count(lambda t: (t.view(32, 64), t.T, t[:, :8],
                                     t[None].expand(4, 64, 32)), t)
    assert views.bytes == 0
    copy = opcount.count(lambda t: t.T.contiguous(), t)
    assert copy.bytes == 2 * 64 * 32 * 4
    assert copy.memory["temp_bytes"] == 64 * 32 * 4


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen1.5-32b",
                                  "minicpm3-4b"])
def test_tiny_forward_products_equal_analyze_hlo(arch):
    """The tiny preset's forward (``attn_impl="naive"``, no remat): the
    port's product FLOPs on meta equal the reference's ``analyze_hlo``
    of the same forward compiled for the CPU, exactly (XLA's CPU build
    fuses none of these dots, so every one is counted).  The dense, GQA
    and MLA presets are compared; the MoE presets are not (the reference
    dispatches by one-hot products, the port by index: other work by
    design), nor the SSD (the port's chunk form computes every chunk's
    intra-chunk terms at once: 1.9% more products at the tiny preset)."""
    jcfg, cfg = jreduced_config(arch, "tiny"), reduced_config(arch, "tiny")
    b, s = 2, 64
    jflags = jtr.RunFlags(attn_impl="naive", remat=False)
    params = jax.eval_shape(lambda: jtr.init(jcfg, jax.random.PRNGKey(0)))
    fwd = jax.jit(lambda p, t: jtr.forward(p, {"tokens": t}, jcfg,
                                           mode="train", flags=jflags)[0])
    text = fwd.lower(params, jax.ShapeDtypeStruct((b, s), jnp.int32)
                     ).compile().as_text()
    ref = jhlo.analyze_hlo(text).flops

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict) else torch.empty(
            v.shape, dtype=cfg.activation_dtype, device="meta")
            for k, v in tree.items()}
    flags = tr.RunFlags(attn_impl="naive", remat=False)
    rec = opcount.count(
        lambda p, batch: tr.forward(p, batch, cfg, mode="train",
                                    flags=flags),
        meta(spec_shapes(tr.model_specs(cfg))),
        {"tokens": torch.empty(b, s, dtype=torch.int32, device="meta")})
    assert ref > 0
    assert rec.op_flops() == ref
    assert rec.flops == ref


# -- the flash kernel's route and cost rule ---------------------------------


@pytest.mark.parametrize("b,s,t,h,dk,dv,causal", [
    (1, 300, 300, 2, 128, 128, True),
    (2, 200, 257, 3, 96, 64, False)])
def test_flash_cost_rule_against_a_hand_count(b, s, t, h, dk, dv, causal):
    """Pairs of the live tiles, counted one q row at a time: the row's q
    tile reaches every kv tile up to the one holding its tile's last
    row (causal), or all of them."""
    bq, bk = kernel_tiles(torch.bfloat16, dk, dv)
    pairs = 0
    for i in range(s):
        q_end = min((i // bq + 1) * bq, s)   # the tile's last row + 1
        cols = -(-q_end // bk) * bk if causal else t
        pairs += min(cols, t)
    useful = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    cost = flash_cost(b, s, t, h, dk, dv, torch.bfloat16, causal)
    assert cost["flops"] == 2 * (dk + dv) * b * h * pairs
    assert cost["useful_flops"] == 2 * (dk + dv) * b * h * useful
    assert cost["bytes"] == 2 * b * h * (s * dk + t * dk + t * dv + s * dv)


def test_flash_useful_count_at_internvl2s_longest_prompt():
    cost = flash_cost(1, 3904, 3904, 48, 128, 128, torch.bfloat16, True)
    assert round(cost["useful_flops"] / 1e9, 1) == 187.3
    assert round(cost["useful_flops"] / 989e12 * 1e3, 4) == 0.1894
    assert cost["flops"] >= cost["useful_flops"]


def test_the_dry_run_counts_the_kernels_route():
    """On meta, attention is the kernel's launch (its cost rule, no
    S×S scores), the backward the plain recompute; a geometry the card's
    kernels refuse raises, as on the card."""
    q = torch.empty(1, 4096, 8, 128, dtype=torch.bfloat16, device="meta")
    rec = opcount.count(lambda q: flash_attention_meta(q, q, q), q)
    assert list(rec.kernels) == ["flash_attention_wgmma"]
    assert rec.kernels["flash_attention_wgmma"]["launches"] == {
        "bfloat16/128/128": 1}
    assert rec.kernels["flash_attention_wgmma"]["flops"] == flash_cost(
        1, 4096, 4096, 8, 128, 128, torch.bfloat16, True)["flops"]
    assert "bmm" not in rec.ops
    assert rec.memory["temp_bytes"] == q.numel() * 2
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_meta(*(torch.empty(1, 64, 2, 40, device="meta",
                                           dtype=torch.bfloat16),) * 3)
    odd = torch.empty(1, 64, 3, 128, dtype=torch.bfloat16,
                      device="meta")[:, :, :, :120]
    with pytest.raises(ValueError):
        flash_attention_meta(odd, odd, odd)


# -- the roofline -----------------------------------------------------------


def _artifact(kind: str) -> dict:
    counts = {"flops": 3.1e14, "bytes": 2.2e12,
              "collective_bytes": {"all-gather": 4.0e10,
                                   "all-reduce": 1.5e10},
              "collective_dcn_bytes": 1.0e10,
              "n_collectives": {"all-gather": 900, "all-reduce": 300}}
    return {"arch": "gemma-7b", "shape": "train_4k", "mesh": "16x16",
            "n_devices": 256, "status": "ok",
            "meta": {"model_flops_per_token": 5.1e10,
                     "tokens_per_step": 1048576},
            "memory_analysis": {"temp_bytes": 7 * 2**30},
            "compile_s": 12.0, kind: counts}


def test_analyze_artifact_matches_the_reference():
    consts = roofline.Consts("TPU v5e", jroofline.PEAK_FLOPS,
                             jroofline.HBM_BW, jroofline.ICI_BW,
                             jroofline.DCN_BW)
    want = jroofline.analyze_artifact(_artifact("hlo_parsed"))
    for kind in ("hlo_parsed", "op_counts"):
        got = roofline.analyze_artifact(_artifact(kind), consts)
        for f in ("compute_s", "memory_s", "collective_s", "dcn_s",
                  "model_flops_global", "hlo_flops_global", "useful_ratio",
                  "mfu_bound", "temp_gb", "dominant", "status"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-12), f
    skipped = {"arch": "hubert-xlarge", "shape": "decode_32k",
               "mesh": "16x16", "status": "skipped", "reason": "no decode"}
    assert roofline.analyze_artifact(skipped).reason == \
        jroofline.analyze_artifact(skipped).reason


def test_load_rows_and_render(tmp_path, capsys):
    (tmp_path / "gemma-7b_train_4k_16x16.json").write_text(
        json.dumps(_artifact("op_counts")))
    (tmp_path / "hymba-1.5b_train_4k_16x16.json").write_text(json.dumps(
        {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "16x16",
         "status": "error", "error": "ValueError: split SSM head"}))
    rows = roofline.load_rows(str(tmp_path))
    assert [(r.arch, r.status) for r in rows] == [("gemma-7b", "ok"),
                                                  ("hymba-1.5b", "error")]
    out = roofline.render(rows)
    text = capsys.readouterr().out
    assert "H100" in text and "ERROR: ValueError: split SSM head" in text
    assert out[0][1] == pytest.approx(rows[0].mfu_bound)
    assert roofline.main(["--dir", str(tmp_path)]) == 0


# -- full-width cells on the production mesh, on meta ------------------------


def _block_bytes(arch: str, shape: str, rank: int) -> int:
    """Σ of the bytes of rank ``rank``'s blocks, by its coordinates on
    the 16×16 mesh (data major)."""
    _fake(rank, 256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        plan = specs.build_cell(arch, shape, mesh)
        args = plan.local_args({"data": rank // 16, "model": rank % 16})
    finally:
        dist.destroy_process_group()
    return sum(t.numel() * t.element_size() for _, t in _leaves(args))


@pytest.mark.parametrize("arch,shape", [("gemma-7b", "prefill_32k"),
                                        ("gemma-7b", "decode_32k"),
                                        ("olmoe-1b-7b", "train_4k")])
def test_a_full_width_cell_counts_on_meta(arch, shape):
    """Full width on the 16×16 mesh, on meta: the counts of rank 0 and
    of the last rank are the same (every rank holds blocks of one
    shape)."""
    arts = [dryrun.run_cell(arch, shape, False, rank=r) for r in (0, 255)]
    assert not dist.is_initialized()
    for art in arts:
        assert art["status"] == "ok"
        mem, oc = art["memory_analysis"], art["op_counts"]
        assert mem["argument_bytes"] == _block_bytes(arch, shape,
                                                     art["rank"])
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert sum(oc["n_collectives"].values()) > 0
        assert oc["flops"] > 0 and oc["bytes"] > 0
        json.dumps(art)
    a, b = arts
    assert a["op_counts"] == b["op_counts"]
    assert a["memory_analysis"] == b["memory_analysis"]
    if shape != "decode_32k":
        assert a["op_counts"]["kernels"]["flash_attention_wgmma"][
            "launches"]


def test_a_refused_cell_is_an_error_artifact(tmp_path):
    """Hymba-1.5B's 50 SSM heads do not divide a model axis of 16: the
    CLI writes an error artifact with the reason and exits 1."""
    rc = dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                      "--mesh", "single", "--dir", str(tmp_path)])
    assert rc == 1
    art = json.loads((tmp_path / "hymba-1.5b_decode_32k_16x16.json")
                     .read_text())
    assert art["status"] == "error"
    assert "ssm_heads" in art["error"]
    assert not dist.is_initialized()
    rc = dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k",
                      "--mesh", "both", "--dir", str(tmp_path)])
    assert rc == 0
    for mesh in ("16x16", "2x16x16"):
        art = json.loads((tmp_path / f"hubert-xlarge_long_500k_{mesh}.json")
                         .read_text())
        assert art["status"] == "skipped"
