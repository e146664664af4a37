"""The port stands alone: importing every ``salun_torch`` module (in a
fresh interpreter, since this suite's conftest imports JAX), the DDPM and
SD slices and their CLIs included, pulls in neither ``jax`` nor the JAX
package ``salun``, and no port file names either in an import statement."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "salun_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax():
    mods = list(_modules())
    for m in ("salun_torch.kernels.masked_update",
              "salun_torch.kernels.flash_attention",
              "salun_torch.kernels.attention",
              "salun_torch.diffusion.schedules", "salun_torch.diffusion.unet",
              "salun_torch.diffusion.sampling", "salun_torch.diffusion.runner",
              "salun_torch.diffusion.losses", "salun_torch.diffusion.ema",
              "salun_torch.data.ddpm_data", "salun_torch.cli.ddpm_config",
              "salun_torch.cli.ddpm_train", "salun_torch.cli.ddpm_sample",
              "salun_torch.kernels.groupnorm_silu",
              "salun_torch.sd.tokenizer", "salun_torch.sd.clip_text",
              "salun_torch.sd.vae", "salun_torch.sd.unet",
              "salun_torch.sd.ldm", "salun_torch.sd.config",
              "salun_torch.sd.data", "salun_torch.sd.trainers",
              "salun_torch.ckpt.sd_import", "salun_torch.cli.sd_train",
              "salun_torch.cli.sd_generate_images",
              "salun_torch.cli.main_train", "salun_torch.cli.main_forget",
              "salun_torch.evalx.mia", "salun_torch.models.vgg",
              "salun_torch.dist.topk", "salun_torch.core.pruner",
              "salun_torch.core.omp", "salun_torch.core.methods.fisher",
              "salun_torch.core.methods.wfisher",
              "salun_torch.core.methods.boundary",
              "salun_torch.core.methods.rl_proximal",
              "salun_torch.core.methods.prune_variants",
              "salun_torch.cli.ddpm_fim", "salun_torch.cli.ddpm_save_base",
              "salun_torch.diffusion.ckpt_util"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'salun'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_port_file_imports_jax_or_salun():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "salun"), f"{path}: imports {name}"
