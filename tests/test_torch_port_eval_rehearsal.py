"""The port's evaluation rehearsal (`scripts/eval_rehearsal.py`) on the CPU at
a tiny size: the port bench's components cut to a U-ViT of width 32, depth 4
on 8x8x4 latents with a VAE of width 32 (f32), 3 solver steps, 4 samples in
batches of 2, and a 16-feature random projection standing in for Inception
(a 2048-d `sqrtm` costs seconds here).  The JSON line has the keys of the
JAX package's `scripts/eval_rehearsal.py` (read from its source with `ast`,
never imported: it needs the root `bench.py` and a TPU), the PNGs are
written, and the self-FD without reference statistics is about 0; with the
gate's imagenet/exactB.npz present the distance is taken against it.
"""
import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from panopticdiffusionmodels_torch.scripts import bench, eval_rehearsal

REPO = Path(__file__).resolve().parents[1]


def jax_keys() -> list:
    tree = ast.parse((REPO / "scripts" / "eval_rehearsal.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in the JAX rehearsal")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    for k, v in dict(REH_N="4", REH_BATCH="2", REH_DIR=str(tmp_path / "reh"),
                     QG_DIR=str(tmp_path / "qg"), BENCH_STEPS="3").items():
        monkeypatch.setenv(k, v)
    components = bench.build_components("cpu", depth=4, embed_dim=32, num_heads=4, img_size=8,
                                        vae_geometry=dict(ch=32, ch_mult=(1, 2),
                                                          num_res_blocks=1),
                                        dtype=torch.float32)
    proj = torch.from_numpy(np.random.default_rng(0).normal(size=(16 * 16 * 3, 16))
                            .astype(np.float32))

    def extractor(images):
        x = torch.as_tensor(np.asarray(images, np.float32))
        return x.reshape(x.shape[0], -1) @ proj

    return tmp_path, components, extractor


def test_rehearsal_prints_jax_keys_and_self_fd(tiny, capsys):
    tmp, components, extractor = tiny
    result = eval_rehearsal.main(components, extractor, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == jax_keys() == list(result)
    assert line["n"] == 4 and line["ref"] == "self"
    assert abs(line["fd_vs_ref"]) < 1e-4  # the sqrtm of a rank-3 covariance's square
    assert sorted(os.listdir(tmp / "reh" / "samples")) == [f"{i}.png" for i in range(4)]
    for k in ("sample2dir_s", "dir_statistics_s", "frechet_s", "end_to_end_img_per_s",
              "protocol_10k_min", "protocol_50k_min"):
        assert line[k] >= 0


def test_rehearsal_reads_the_gates_reference(tiny, capsys):
    tmp, components, extractor = tiny
    ref = Path(eval_rehearsal.reference_stats())
    assert ref == tmp / "qg" / "imagenet" / "exactB.npz"
    ref.parent.mkdir(parents=True)
    np.savez(ref, mu=np.ones(16), sigma=np.eye(16))
    line = eval_rehearsal.main(components, extractor, device="cpu")
    assert line["ref"] == "quality_gate exactB" and line["fd_vs_ref"] > 0


def test_rehearsal_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_rehearsal.main()
