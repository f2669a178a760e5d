"""The port's `scripts/convert_checkpoint.py` against the JAX package's
`scripts/convert_checkpoint.py` (JAX l.37-66; `tests/test_weights_runbook.py`
drills the JAX side): a reference-format .pth of a tiny t2i config with
`config.pretrained` set (the JAX export of a seeded network, plus the
reference's unused even-index zero convs) through both scripts.  The port's
`0.ckpt` resumes strictly into `Trainer`, which freezes the image stream as
the script did, at step 0; its parameters and EMA equal the JAX
checkpoint's parameters carried by `utils/torch_bridge.export_uvit_t2i`, to
1e-6; and the resumed trainer takes a step."""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from panopticdiffusionmodels_tpu import cli as jax_cli
from panopticdiffusionmodels_tpu.configs import get_config as jax_get_config
from panopticdiffusionmodels_tpu.train import checkpoint as jax_ckpt
from panopticdiffusionmodels_tpu.utils.torch_bridge import (
    convert_uvit_t2i,
    export_uvit_t2i,
    save_torch_state_dict,
)
from panopticdiffusionmodels_torch.configs import get_config
from panopticdiffusionmodels_torch.models import get_nnet
from panopticdiffusionmodels_torch.scripts import convert_checkpoint
from panopticdiffusionmodels_torch.train.trainer import Trainer
from panopticdiffusionmodels_torch.utils.weights import reference_nnet_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CONFIG = '''from panopticdiffusionmodels_torch.configs import get_config as zoo


def get_config():
    config = zoo("synthetic_tiny")
    config.pretrained = {pth!r}
    config.num_workers = 0
    return config
'''


def reference_pth(path: Path) -> dict:
    kw = dict(get_config("synthetic_tiny").nnet)
    torch.manual_seed(5)
    nnet = get_nnet(kw.pop("name"), **kw)
    with torch.no_grad():
        for name, p in nnet.named_parameters():
            if name.startswith("zero_convs"):  # open them: the mask stream feeds the image's
                p.normal_(0, 0.02)
    params = convert_uvit_t2i({k: v.numpy() for k, v in nnet.state_dict().items()}, depth=4)
    sd = export_uvit_t2i(params, patch_size=2, mask_patch_size=4)
    sd.update({f"zero_convs.{2 * i}.conv.{n}": np.zeros(s, np.float32)
               for i in range(5) for n, s in (("weight", (32, 32, 1)), ("bias", (32,)))})
    save_torch_state_dict(sd, str(path))
    return sd


def run_jax_script(monkeypatch, pth: str, out: str) -> None:
    config = jax_get_config("synthetic_tiny")
    config.pretrained = pth
    monkeypatch.setattr(jax_cli, "load_config", lambda spec: config)
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  ROOT / "scripts" / "convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", "--config", "synthetic_tiny",
                                      "--nnet", pth, "--out", out])
    mod.main()


def test_converted_checkpoint_resumes_and_equals_jax(tmp_path, monkeypatch):
    pth = tmp_path / "nnet_ema.pth"
    reference_pth(pth)
    cfg = tmp_path / "tiny_pretrained.py"
    cfg.write_text(CONFIG.format(pth=str(pth)))
    path = convert_checkpoint.main(["--config", str(cfg), "--nnet", str(pth),
                                    "--out", str(tmp_path / "port" / "ckpts"),
                                    "--device", "cpu"])
    assert Path(path) == tmp_path / "port" / "ckpts" / "0.ckpt" and Path(path).is_file()
    run_jax_script(monkeypatch, str(pth), str(tmp_path / "jax" / "ckpts"))
    jax_params = jax_ckpt.load_checkpoint(str(tmp_path / "jax" / "ckpts" / "0.ckpt"))["params"]
    want = reference_nnet_state_dict(export_uvit_t2i(jax.tree.map(np.asarray, jax_params),
                                                     patch_size=2, mask_patch_size=4))

    from panopticdiffusionmodels_torch.cli import load_config

    trainer = Trainer(load_config(str(cfg)), str(tmp_path / "port"), device="cpu")
    assert trainer.state.frozen, "config.pretrained freezes the image stream"
    assert trainer.resume() and trainer.state.step == 0
    assert sorted(trainer.state.params) == sorted(want)
    for name, p in trainer.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(trainer.state.ema[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 0 and not payload["opt_state"]["state"]
    trainable = [n for n in trainer.state.params if n not in trainer.state.frozen]
    assert len(payload["opt_state"]["param_groups"][0]["params"]) == len(trainable)
    trainer.fit(max_steps=1)
    assert trainer.state.step == 1
