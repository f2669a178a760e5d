"""The port's measurement scripts (`panopticdiffusionmodels_torch/scripts/`:
bench_train, bench_serving, bench_protocols, bench_speed_modes,
bench_breakdown, bench_unet, bench_eval_io, bench_loader, bench_attention,
bench_ring_hop, verify_kernel, verify_e2e) on the CPU.

- Their constants equal the JAX package's root scripts', read from the
  sources with `ast` (a root script is never imported: it points JAX's
  compilation cache at a fixed directory when imported): `PROTOCOLS`, the
  default batches, policies, modes and shapes, and every BENCH_* / RING_*
  variable the JAX script reads is read by the port's (or by the port's
  `scripts/bench.py` it builds on).
- Each script's `main` runs on the CPU at a tiny width through an explicit
  device and its width hook, and ends with one JSON line whose keys are
  the script's, with finite numbers and the card fields.
- Asked for `cuda` on a machine without a card, each script that uses the
  device raises before it builds anything; `bench_loader`, a host
  benchmark, refuses no device.
"""
import ast
import json
import math
import os
from pathlib import Path

import pytest
import torch

from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.scripts import (
    bench,
    bench_attention,
    bench_breakdown,
    bench_eval_io,
    bench_loader,
    bench_protocols,
    bench_ring_hop,
    bench_serving,
    bench_speed_modes,
    bench_train,
    bench_unet,
    verify_e2e,
    verify_kernel,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "panopticdiffusionmodels_torch" / "scripts"
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY = dict(depth=2, embed_dim=32, num_heads=2, img_size=8, vae_geometry=VAE,
            dtype=torch.float32)
# root script -> the port's script, and the port's files its environment is read in
PAIRS = {
    "bench_train.py": ("bench_train.py",),
    "bench_serving.py": ("bench_serving.py",),
    "bench_protocols.py": ("bench_protocols.py", "bench.py"),
    "bench_speed_modes.py": ("bench_speed_modes.py",),
    "bench_breakdown.py": ("bench_breakdown.py", "bench.py"),
    "bench_unet.py": ("bench_unet.py",),
    "bench_eval_io.py": ("bench_eval_io.py",),
    "bench_loader.py": ("bench_loader.py",),
    "bench_attention.py": ("bench_attention.py",),
    "bench_ring_hop.py": ("bench_ring_hop.py",),
    "verify_kernel_tpu.py": ("verify_kernel.py",),
    "verify_e2e_tpu.py": ("verify_e2e.py",),
}


def tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def literal(node):
    """A literal, with `dict(k=literal, ...)` calls evaluated."""
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dict":
        return {kw.arg: literal(kw.value) for kw in node.keywords}
    if isinstance(node, ast.Dict):
        return {literal(k): literal(v) for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def env_names(path: Path) -> set:
    """The variables `os.environ.get(...)` reads in a source file."""
    out = set()
    for node in ast.walk(tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "environ" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


def argv_defaults(path: Path) -> list:
    """The `<argv> or <list literal>` defaults of a source file, in order."""
    return [literal(node.values[1]) for node in ast.walk(tree(path))
            if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or)
            and len(node.values) == 2 and isinstance(node.values[1], ast.List)]


def loop_literals(path: Path) -> list:
    """The literal lists and tuples the `for` loops of a source file run over."""
    out = []
    for node in ast.walk(tree(path)):
        if isinstance(node, ast.For) and isinstance(node.iter, (ast.List, ast.Tuple)):
            try:
                out.append(literal(node.iter))
            except ValueError:
                pass
    return out


@pytest.mark.parametrize("root", sorted(PAIRS))
def test_environment_of_each_root_script_is_read(root):
    want = {n for n in env_names(REPO / "scripts" / root) if n != "JAX_CACHE_DIR"}
    got = set().union(*(env_names(PORT / f) for f in PAIRS[root]))
    assert want <= got, sorted(want - got)


def test_protocols_equal_the_root_scripts():
    consts = {t.id: node.value for node in tree(REPO / "scripts" / "bench_protocols.py").body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name)}
    assert literal(consts["PROTOCOLS"]) == bench_protocols.PROTOCOLS
    for name, p in bench_protocols.PROTOCOLS.items():
        nnet = get_config(bench_protocols.CONFIGS[name]).nnet
        assert {k: nnet[k] for k in ("img_size", "patch_size", "embed_dim", "depth",
                                     "num_heads")} == {k: p[k] for k in (
                                         "img_size", "patch_size", "embed_dim", "depth",
                                         "num_heads")}
        assert get_config(bench_protocols.CONFIGS[name]).sample.scale == p["cfg_scale"]
        assert bench_protocols.attention_shape(name, p["batch"]) == (
            32, 258, 16, p["embed_dim"] // 16)


def test_defaults_equal_the_root_scripts():
    src = (REPO / "scripts" / "bench_train.py").read_text()
    assert 'default_b = "48" if os.environ.get("BENCH_TASK", "") == "panoptic512" else "64"' \
        in src
    assert [bench_train.default_batch(t) for t in bench_train.TASKS] == [64, 64, 48]
    assert argv_defaults(REPO / "scripts" / "bench_train.py") == [
        bench_train.DEFAULT_POLICIES]
    assert argv_defaults(REPO / "scripts" / "bench_serving.py") == [
        bench_serving.DEFAULT_BATCHES]
    assert argv_defaults(REPO / "scripts" / "bench_speed_modes.py") == [
        bench_speed_modes.DEFAULT_MODES]
    loops = loop_literals(REPO / "scripts" / "bench_attention.py")
    assert bench_attention.ISOLATED_SHAPES in loops
    loops = loop_literals(REPO / "scripts" / "verify_kernel_tpu.py")
    for want in (verify_kernel.KERNEL_SHAPES, verify_kernel.TRAIN_SHAPES,
                 verify_kernel.HOP_SHAPES, verify_kernel.TRAIN_IMPLS,
                 verify_kernel.REMAT_POLICIES):
        assert want in loops, want
    assert bench_loader.N_BATCHES == 40
    assert "n_batches = 40" in (REPO / "scripts" / "bench_loader.py").read_text()


def tiny_t2i(config):
    config.compute_dtype = "float32"
    config.nnet.update(img_size=8, embed_dim=32, depth=2, num_heads=2, mask_size=16,
                       clip_dim=16, num_clip_token=7)
    config.z_shape = (8, 8, 4)
    return config


def shrink_train(config):
    config.compute_dtype = "float32"
    config.nnet.update(embed_dim=32, depth=2, num_heads=2, img_size=8)
    config.z_shape = (8, 8, 4)
    config.dataset.update(z_shape=(8, 8, 8))
    if config.task == "t2i_discrete":
        config.nnet.update(mask_size=16, clip_dim=16, num_clip_token=7)
        config.dataset.update(clip_shape=(7, 16), mask_size=16)
    config.num_workers = 0


def run_serving():
    config = tiny_t2i(get_config("mscoco_uvit_small"))
    config.sample.sample_steps = 5
    del config["autoencoder"]  # latents stand in for images here
    return bench_serving.main(["--device=cpu", "2"], config=config)


def run_unet():
    config = get_config("mscoco_unet")
    config.nnet.update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1, num_heads=2,
                       sample_size=8, mask_size=16, clip_dim=16, num_clip_token=7)
    config.z_shape = (8, 8, 4)
    return bench_unet.main(["--device=cpu"], config=config, vae_geometry=VAE)


def run_eval_io(monkeypatch):
    monkeypatch.setenv("BENCH_N", "5")
    monkeypatch.setenv("BENCH_ROUNDS", "2")
    record = bench_eval_io.main(
        ["--device=cpu"], components=bench.build_components("cpu", **TINY),
        extractor=lambda x: torch.as_tensor(x).reshape(len(x), -1)[:, :16])
    assert [a["overlap"] for a in record["sample2dir"]] == [False, True, True, False]
    return record


def run_ring(monkeypatch):
    for k, v in dict(RING_BATCH="2", RING_LQ="9", RING_DEPTH="2").items():
        monkeypatch.setenv(k, v)
    return bench_ring_hop.main(["--device=cpu"], heads=2, head_dim=8)


def run_verify_kernel():
    uv = dict(verify_kernel.UVIT_L, img_size=8, embed_dim=32, depth=2, num_heads=2)
    s2 = dict(verify_kernel.S2, img_size=8, embed_dim=32, depth=2, num_heads=2, mask_size=16,
              clip_dim=16, num_clip_token=7)
    return verify_kernel.main(["--device=cpu"], tiny=dict(
        kernel_shapes=[(2, 10, 2, 8)], train_shapes=[(2, 9, 2, 8)],
        hop_shapes=[(9, 9, 9), (8, 8, 5)], hop=(2, 2, 8), uvit=uv,
        remat_uvit=dict(uv, num_classes=11), s2=s2, batch=2))


RUNS = {
    "bench_train": (lambda mp: bench_train.main(["--device=cpu", ""], shrink=shrink_train),
                    {"task", "batch", "runs"}),
    "bench_serving": (lambda mp: run_serving(), {"reps", "modes"}),
    "bench_protocols": (lambda mp: bench_protocols.main(
        ["--device=cpu", "256H"], dims=dict(TINY, num_heads=2, embed_dim=144)),
        {"protocol", "config", "batch", "reps", "images_per_s", "kernel_parity", "requests",
         "kernel_launches", "real_evals_per_request"}),
    "bench_speed_modes": (lambda mp: bench_speed_modes.main(
        ["--device=cpu", "accel=0.2", "gelu=tanh", "full=0.2:0.0,0.5"],
        components=bench.build_components("cpu", **TINY)), {"batch", "reps", "modes"}),
    "bench_breakdown": (lambda mp: bench_breakdown.main(
        ["--device=cpu"], components=bench.build_components("cpu", **TINY)),
        {"batch", "reps", "cfg_interval", "full_ms", "solver_ms", "decode_ms", "cfg_forward_ms",
         "real_evals", "images_per_s", "solver_share", "decode_share", "forwards_share",
         "residual_ms", "kernel_launches_per_call"}),
    "bench_unet": (lambda mp: run_unet(),
                   {"batch", "steps", "reps", "panoptic", "params", "first_run_s", "finite",
                    "finite_mask", "image_shape", "images_per_s", "best_ms", "real_evals",
                    "launches"}),
    "bench_eval_io": (run_eval_io, {"batch", "n_samples", "rounds", "sample2dir", "fid_stats",
                                    "kernel_launches", "real_evals_per_batch"}),
    "bench_loader": (lambda mp: bench_loader.main(["6", "3"]),
                     {"n_samples", "batch", "batches", "native", "python"}),
    "bench_attention": (lambda mp: bench_attention.main(
        ["--device=cpu"], shapes=[(2, 10, 2, 8)],
        dims=dict(depth=2, embed_dim=32, num_heads=2, img_size=8), batch=2),
        {"isolated", "insitu"}),
    "bench_ring_hop": (run_ring, {"batch", "lq", "heads", "head_dim", "sp", "depth", "reps",
                                  "parity_rel_dev", "parity_bar", "plain_hop", "kernel_hop"}),
    "verify_kernel": (lambda mp: run_verify_kernel(), {"checks", "bars", "ok"}),
    "verify_e2e": (lambda mp: verify_e2e.main(["--device=cpu"], steps=100),
                   {"steps", "windows", "loss_first", "loss_last", "sample_shape",
                    "mask_shape", "resumed_step", "launches", "ok"}),
}


def numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from numbers(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


@pytest.mark.parametrize("name", sorted(RUNS))
def test_main_on_the_cpu_ends_with_one_json_line(name, monkeypatch, capsys):
    for k, v in dict(BENCH_REPS="1", BENCH_BATCH="2", BENCH_STEPS="5").items():
        monkeypatch.setenv(k, v)
    run, keys = RUNS[name]
    record = run(monkeypatch)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == record
    assert not any(line.startswith("{") for line in lines[:-1])
    assert set(record) == {"script", "device", "card"} | keys
    assert record["script"] == name
    assert record["card"] == {"name": None, "power_limit": None}
    assert all(math.isfinite(v) for v in numbers(record))
    assert record.get("ok", True) is True


@pytest.mark.parametrize("name", sorted(set(RUNS) - {"bench_loader"}))
def test_cuda_without_a_card_raises(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = globals()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device=cuda"], device="cpu")


def test_bench_train_env_overrides(monkeypatch):
    for k, v in dict(BENCH_TRANSFER="bfloat16", BENCH_GELU="tanh", BENCH_REMAT="off",
                     BENCH_ATTN="pallas_recompute").items():
        monkeypatch.setenv(k, v)
    for task in bench_train.TASKS:
        config = bench_train.apply_env_overrides(bench_train.build_config("dots", 8, task))
        assert config.train.transfer_dtype == "bfloat16"
        assert config.nnet.gelu_approx and not config.nnet.use_checkpoint
        assert config.nnet.attn_impl == "pallas_recompute"
        assert config.nnet.remat_policy == "dots" and config.train.batch_size == 8
    big = bench_train.build_config("", 48, "panoptic512")
    assert (big.z_shape, big.nnet.mask_size, big.nnet.depth) == ((64, 64, 4), 128, 12)
    assert bench_train.build_config("", 64, "latentL").nnet.num_classes == 1001
    with pytest.raises(SystemExit):
        bench_train.build_config("", 8, "panoptic1024")


def test_speed_mode_grammar():
    parse = bench_speed_modes.mode_knobs
    assert parse("accel=0.3") == (0.3, None, False)
    assert parse("interval=0.0,0.5") == (0.0, (0.0, 0.5), False)
    assert parse("combo=0.2:0.0,0.5") == (0.2, (0.0, 0.5), False)
    assert parse("full=0.2:0.0,0.5") == (0.2, (0.0, 0.5), True)
    assert parse("gelu=tanh") == (0.0, None, True)
    assert parse("gelu_accel=0.2") == (0.2, None, True)
    for refused in ("fast=1", "steps=20", "ihold=0.0,0.5", "full_hold=0.2:0.0,0.5"):
        with pytest.raises(SystemExit):
            parse(refused)


def test_scripts_import_nothing_of_jax():
    for path in PORT.glob("*.py"):
        for node in ast.walk(tree(path)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "panopticdiffusionmodels_tpu", "flax")
                           for n in names), (path.name, names)
    assert os.path.basename(bench.__file__) == "bench.py"
