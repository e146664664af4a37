"""The port's ``sd_eval`` CLI and diffusers export against ``salun``.

- ``imageclassify`` against ``salun.cli.sd_eval.imageclassify`` on the
  same seeded torchvision-format ResNet-50 ``.pth`` and PNGs (non-square,
  so the resize and crop run), with and without ``--prompts_path``: the
  CSVs hold the same rows and columns, integers and strings equal, scores
  within 1e-5 absolute (softmax of fp32 ResNet-50 logits summed in other
  orders); the preprocessing bitwise.
- ``compute_fid`` on both CLIs with one pytorch-fid-named ``.pth``: the
  pool features within 1e-4 of their largest value, the FID (computed on
  the first 64 dims on both sides, as ``test_torch_fid.py`` does) within
  1e-3 relative.
- ``detect_nude_classes`` with a fake detector: the CSV equals JAX's byte
  for byte; without the nudenet package both stop with instructions.
- The diffusers export of the bridged tiny U-Net equals JAX's key for key
  and tensor for tensor (bitwise), import∘export is the identity, and at
  the full width of sd-v1 the key map equals JAX's.
"""

import csv
import sys
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

import salun.cli.sd_eval as jax_sd_eval
import salun.evalx.inception as jax_inc
from _torch_port import (one_torch_thread, sd_perturbed_params,  # noqa: F401
                         sd_tiny_jax)
from salun.sd.diffusers_export import export_diffusers_unet as jax_export
from salun_torch.cli import sd_eval
from salun_torch.cli.ddpm_sample import write_png
from salun_torch.ckpt import sd_state_dict_from_jax
from salun_torch.models import create_model
from salun_torch.sd.diffusers_export import (export_diffusers_unet,
                                             import_diffusers_unet,
                                             save_diffusers_unet)

# --------------------------------------------------------------- classify


@pytest.fixture(scope="module")
def classify_inputs(tmp_path_factory):
    """A seeded ResNet-50 (ImageNet stem, 1,000 classes) saved as a
    torchvision-format state dict, with BN statistics, and 5 PNGs of two
    prompt rows. The seeded features are large (logits' spread ~120 over
    the classes), so the fc is scaled to a spread of ~2: the top-5 stay
    well apart and no softmax value underflows to a tie at 0."""
    tmp = tmp_path_factory.mktemp("classify")
    model = create_model("resnet50", 1000, imagenet=True, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))
        model.fc.weight.div_(60.0)
    weights = tmp / "resnet50.pth"
    torch.save(model.state_dict(), weights)
    rng = np.random.default_rng(5)
    folder = tmp / "images"
    folder.mkdir()
    for name, (h, w) in (("0_0", (240, 300)), ("0_1", (300, 240)),
                         ("3_0", (256, 256)), ("3_1", (233, 400)),
                         ("7_0", (240, 240))):
        write_png(str(folder / f"{name}.png"),
                  rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    prompts = tmp / "prompts.csv"
    prompts.write_text("case_number,prompt,evaluation_seed,classidx\n"
                       "0,an image of a tench,42,0\n3,a cat,7,281\n"
                       "5,no image,1,5\n")
    cats = tmp / "categories.txt"
    cats.write_text("".join(f"class {i}\n" for i in range(1000)))
    return tmp, weights, folder, prompts, cats


def test_classifier_preprocess_matches_jax(classify_inputs):
    folder = classify_inputs[2]
    for p in sorted(folder.iterdir()):
        got = sd_eval._classifier_preprocess(str(p))
        assert got.shape == (224, 224, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jax_sd_eval._classifier_preprocess(str(p)))


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("merged", [True, False], ids=["prompts", "images"])
def test_imageclassify_matches_jax(classify_inputs, merged, capsys):
    tmp, weights, folder, prompts, cats = classify_inputs
    common = dict(folder_path=str(folder), classifier_weights=str(weights),
                  categories=str(cats) if merged else None, topk=5,
                  batch_size=2, prompts_path=str(prompts) if merged else None)
    jax_csv, port_csv = tmp / f"jax_{merged}.csv", tmp / f"port_{merged}.csv"
    jax_sd_eval.imageclassify(Namespace(save_path=str(jax_csv), **common))
    want_out = capsys.readouterr().out
    stats = sd_eval.main(
        ["imageclassify", "--save_path", str(port_csv), "--device", "cpu"]
        + [x for k, v in common.items() if v is not None
           for x in (f"--{k}", str(v))])
    got_out = capsys.readouterr().out
    assert stats["images"] == 5 and stats["seconds"] > 0
    want, got = _read(jax_csv), _read(port_csv)
    assert got[0] == want[0]
    # prompts: cases 0 and 3 have two images each, 5 none, image 7 no row
    assert len(got) == len(want) == (5 if merged else 6)
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(got[0], g_row, w_row):
            if col.startswith("scores_top"):
                assert abs(float(g) - float(w)) <= 1e-5, col
            else:
                assert g == w, col
    if merged:  # the UA line, from the same top-1 indices
        assert [ln for ln in got_out.splitlines() if "UA" in ln] == [
            ln for ln in want_out.splitlines() if "UA" in ln]
        assert any("UA" in ln for ln in got_out.splitlines())


def test_imageclassify_needs_images(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit):
        sd_eval.main(["imageclassify", "--folder_path",
                      str(tmp_path / "empty"), "--device", "cpu"])


# --------------------------------------------------------------- FID


def test_compute_fid_matches_jax(tmp_path, monkeypatch):
    from test_torch_fid import _flax_vars
    import salun_torch.evalx.inception as inc

    params, stats = _flax_vars(jax_inc.InceptionV3(), (1, 32, 32, 3), 0)
    model = inc.InceptionV3()
    model.load_state_dict(inc.state_dict_from_flax(params, stats),
                          strict=True)
    weights = tmp_path / "pt_inception.pth"
    torch.save(model.state_dict(), weights)
    rng = np.random.default_rng(6)
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        for i in range(5):
            write_png(str(tmp_path / name / f"{i}.png"),
                      rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))

    # scipy's sqrtm at 2,048 dims takes tens of seconds: both sides see
    # the first 64 dims of the pool features
    seen = {}

    def truncated(side, real):
        def make(*a, **kw):
            extract = real(*a, **kw)

            def run(images):
                pool, spatial, smax = extract(images)
                seen.setdefault(side, []).append(pool)
                return pool[:, :64], spatial, smax
            return run
        return make

    monkeypatch.setattr(jax_inc, "make_feature_fn",
                        truncated("jax", jax_inc.make_feature_fn))
    monkeypatch.setattr(sd_eval, "make_feature_fn",
                        truncated("port", sd_eval.make_feature_fn))
    folders = [str(tmp_path / "a"), str(tmp_path / "b")]
    want = jax_sd_eval.compute_fid(Namespace(
        folder1=folders[0], folder2=folders[1],
        inception_weights=str(weights), batch_size=4))
    got = sd_eval.main(["compute_fid", *folders, "--inception_weights",
                        str(weights), "--batch_size", "4", "--device", "cpu"])
    for g, w in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


# --------------------------------------------------------------- NudeNet


class _FakeDetector:
    """``NudeDetector.detect`` on a table keyed by file name."""

    TABLE = {"0_0.png": [{"class": "FEMALE_BREAST_EXPOSED", "score": 0.9},
                         {"class": "FACE_FEMALE", "score": 0.2}],
             "3_0.png": [{"class": "BELLY_EXPOSED", "score": 0.0}],
             "4_1.png": [{"class": "ARMPITS_EXPOSED", "score": 0.7},
                         {"class": "FEET_EXPOSED", "score": 0.6}]}

    def detect(self, path):
        return self.TABLE[path.split("/")[-1]]


def test_detect_nude_classes_matches_jax(tmp_path):
    prompts = tmp_path / "unsafe.csv"
    prompts.write_text("case_number,prompt,evaluation_seed\n"
                       "0,\"a, b\",1\n3,c,2\n4,d,3\n9,e,4\n")
    images = [str(tmp_path / n) for n in ("0_0.png", "3_0.png", "4_1.png")]
    for th in (0.0, 0.5):
        want, got = tmp_path / f"jax{th}.csv", tmp_path / f"port{th}.csv"
        jax_sd_eval.detect_nude_classes(images, str(prompts), str(want), th,
                                        detector=_FakeDetector())
        sd_eval.detect_nude_classes(images, str(prompts), str(got), th,
                                    detector=_FakeDetector())
        assert got.read_bytes() == want.read_bytes()
    assert sd_eval.nude_label(_FakeDetector.TABLE["4_1.png"], 0.6) == (
        "ARMPITS_EXPOSED")


def test_nudenet_without_the_package_stops_with_instructions(tmp_path,
                                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "nudenet", None)  # import fails
    prompts = tmp_path / "p.csv"
    prompts.write_text("case_number,prompt\n0,a\n")
    for extra in (["--prompts_path", str(prompts)], []):
        with pytest.raises(SystemExit, match="nudenet is not installed"):
            sd_eval.main(["nudenet", "--folder", str(tmp_path),
                          "--save_path", str(tmp_path / "n.csv"), *extra])
    with pytest.raises(SystemExit, match="nudenet is not installed"):
        jax_sd_eval.detect_nude_classes([], str(prompts),
                                        str(tmp_path / "j.csv"), 0.0)


# --------------------------------------------------------------- diffusers

TINY = dict(num_levels=2, num_res_blocks=1, attn_levels=(0, 1))
PREFIX = "model.diffusion_model."


def test_diffusers_export_matches_jax(tmp_path):
    modules = sd_tiny_jax()
    params = sd_perturbed_params(modules)
    unet_sd = {k[len(PREFIX):]: v for k, v in sd_state_dict_from_jax(
        {"unet": params["unet"]}).items()}
    want = jax_export(params["unet"], **TINY)
    got = export_diffusers_unet(unet_sd, **TINY)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    back = import_diffusers_unet(got, unet_sd, **TINY)
    assert list(back) == list(unet_sd)
    for k, v in unet_sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(KeyError):
        import_diffusers_unet({k: v for k, v in got.items()
                               if k != "conv_in.weight"}, unet_sd, **TINY)


def test_diffusers_key_map_at_full_width_matches_jax(tmp_path):
    """sd-v1's U-Net (4 levels, 2 res blocks, attention at 0-2): the
    port's export of a meta-device state dict against JAX's export of a
    stub tree of its param shapes (the keys only), then the file."""
    from salun.sd import SDModules as JaxSD
    from salun_torch.sd.unet import SDUNet, SDUNetConfig

    jax_modules = JaxSD.create()
    shapes = jax.eval_shape(
        lambda k: jax_modules.unet.init(
            k, jax.numpy.zeros((1, 8, 8, 4)), jax.numpy.zeros((1,)),
            jax.numpy.zeros((1, 77, 768)))["params"], jax.random.PRNGKey(0))
    stub = jax.tree.map(lambda s: np.zeros(1, np.float32), shapes)
    want = set(jax_export(stub))
    with torch.device("meta"):
        unet_sd = SDUNet(SDUNetConfig()).state_dict()
    got = export_diffusers_unet(unet_sd)
    assert set(got) == want
    assert len(got) == len(unet_sd) == len(jax.tree.leaves(shapes))
    for k in ("up_blocks.0.upsamplers.0.conv.weight",
              "up_blocks.3.attentions.2.proj_out.weight",
              "down_blocks.3.resnets.1.conv2.weight",
              "mid_block.attentions.0.transformer_blocks.0.ff.net.2.bias"):
        assert k in got, k
    assert not any(k.startswith("up_blocks.0.attentions") for k in got)
    # the tiny U-Net's file: torch-loadable, every tensor on the CPU
    modules = sd_tiny_jax()
    unet_sd = {k[len(PREFIX):]: v for k, v in sd_state_dict_from_jax(
        {"unet": sd_perturbed_params(modules)["unet"]}).items()}
    path = tmp_path / "unet.bin"
    save_diffusers_unet(unet_sd, str(path), **TINY)
    loaded = torch.load(path, weights_only=True)
    want = export_diffusers_unet(unet_sd, **TINY)
    assert list(loaded) == list(want)
    assert all(torch.equal(loaded[k], v) for k, v in want.items())
