"""The port's superpixel modules on the CPU against the JAX package: the
C++ runtime's binding (LSC, SLIC, the shrink) exactly, its build under
``build/torch_ext/`` with nothing written under ``native/``, the
alternative front-ends exactly, and SpixelNet with carried weights within
1e-5 (f32, eval mode)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import _randomize_bn
from uemda_tpu.superpixels import alt as j_alt
from uemda_tpu.superpixels import native as j_native
from uemda_tpu.superpixels.spixelnet import SpixelNet as JaxSpixelNet
from uemda_tpu_torch.models.port import spixelnet_state_dict_from_jax
from uemda_tpu_torch.superpixels import alt, native
from uemda_tpu_torch.superpixels.spixelnet import SpixelNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h=96, w=128, seed=0):
    """A smooth colour field with a few blobs: superpixels with structure,
    on a non-square image so that a swapped H and W shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(8, 30)
        img += rng.uniform(0, 160, 3) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("algo", ["lsc", "slic"])
def test_binding_matches_jax_exactly(algo):
    """96 x 128 RGB: ``slic_superpixels`` (count and map),
    ``edge_shrink`` (the default and an explicit boundary id, window 1 and
    3) and ``superpixels_with_shrink`` (region 16 and 12) equal the JAX
    binding's bit for bit. At region 12 the count exceeds the boundary id
    (h/12)(w/12) = 80 on this image, as in JAX."""
    img = _image()
    n, lab = native.slic_superpixels(img, 16, 0.075, 20, algo)
    jn, jlab = j_native.slic_superpixels(img, 16, 0.075, 20, algo)
    assert lab.shape == (96, 128) and lab.dtype == np.int32
    assert n == jn and n > 10 and np.array_equal(lab, jlab)
    assert lab.min() == 0 and lab.max() == n - 1
    for win, bid in ((3, None), (1, 999)):
        got = native.edge_shrink(lab, win, bid)
        np.testing.assert_array_equal(got, j_native.edge_shrink(jlab, win, bid))
        assert (got == (48 if bid is None else bid)).any()
    for rs in (16, 12):
        got = native.superpixels_with_shrink(img, rs, 0.075, 10, 3, algo)
        want = j_native.superpixels_with_shrink(img, rs, 0.075, 10, 3, algo)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        # the boundary id is (h/rs)(w/rs) whatever the count: at region 12
        # LSC makes more ids than that here, and the top id is a real one
        bid = (96 // rs) * (128 // rs)
        assert (got[2] == bid).any() and got[2].max() == max(bid, got[0] - 1)


def _dir_state(d):
    """{name: (size, mtime)} of every file in ``d``."""
    return {n: (os.stat(os.path.join(d, n)).st_size,
                os.stat(os.path.join(d, n)).st_mtime_ns)
            for n in sorted(os.listdir(d))}


def _untracked_native():
    """Untracked files under ``native/`` by ``git status`` (the JAX
    binding may rebuild its tracked ``libsuperpixels.so`` there in another
    test at any time; the port must add nothing)."""
    out = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all",
                          "--", "native"], cwd=ROOT, capture_output=True,
                         text=True).stdout
    return [line for line in out.splitlines() if line.startswith("??")]


def test_build_lands_in_build_dir_and_leaves_native_alone(tmp_path):
    """The library's default path is ``<root>/build/torch_ext/``, its
    source ``<root>/native/superpixels.cpp``; building there adds no file
    under ``native/`` (``git status``). Three processes that build one
    copy of the source into one fresh build dir at once each load a whole
    library (pid-unique temporary files, then a rename), the build dir
    ends holding that library alone, and the source's directory is
    unchanged (names, sizes, mtimes)."""
    assert native.lib_path().parent == native.ROOT / "build" / "torch_ext"
    assert native.SOURCE == native.ROOT / "native" / "superpixels.cpp"
    assert str(native.ROOT) == ROOT
    listing = sorted(os.listdir(os.path.join(ROOT, "native")))
    untracked = _untracked_native()
    assert native.build().exists()
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == listing
    assert _untracked_native() == untracked == []

    src_dir = tmp_path / "native"
    src_dir.mkdir()
    src = src_dir / "superpixels.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    before = _dir_state(src_dir)
    build_dir = tmp_path / "build" / "torch_ext"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from uemda_tpu_torch.superpixels import native\n"
        "native.SOURCE, native.BUILD_DIR = Path(%r), Path(%r)\n"
        "import numpy as np\n"
        "n, lab = native.slic_superpixels(np.zeros((32, 48, 3), np.uint8) + "
        "np.arange(48, dtype=np.uint8)[None, :, None] * 5, 16, 0.075, 5)\n"
        "print(native.lib_path(), n, lab.shape)\n"
        % (ROOT, str(src), str(build_dir)))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o[0].strip() for o in outs}
    assert len(lines) == 1, lines
    lib = lines.pop().split()[0]
    assert os.path.dirname(lib) == str(build_dir)
    assert [f.name for f in build_dir.iterdir()] == [os.path.basename(lib)]
    assert _dir_state(src_dir) == before


def test_binding_refuses_what_the_c_code_cannot_read():
    """A grey (H, W) image, a two-channel one and a 3-D label map raise
    before any pointer reaches the C code."""
    with pytest.raises(ValueError, match="H, W, 3"):
        native.slic_superpixels(np.zeros((16, 16), np.uint8))
    with pytest.raises(ValueError, match="H, W, 3"):
        native.slic_superpixels(np.zeros((16, 16, 2), np.uint8))
    with pytest.raises(ValueError, match="label map"):
        native.edge_shrink(np.zeros((2, 16, 16), np.int32))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output and leaves
    no library behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any((tmp_path / "out").iterdir())


def test_alt_matches_jax_exactly():
    """``grid_superpixels`` on ragged sizes, ``lda_project`` with and
    without labels and ``slic_on_projection`` equal the JAX module's."""
    for hw, rs in (((50, 70), 16), ((64, 64), 8), ((17, 5), 4)):
        np.testing.assert_array_equal(alt.grid_superpixels(hw, rs),
                                      j_alt.grid_superpixels(hw, rs))
    img = _image(48, 64, seed=1)
    labels = (np.arange(48 * 64).reshape(48, 64) // 500 % 3).astype(np.int32)
    labels[:4] = -1
    np.testing.assert_array_equal(alt.lda_project(img, labels),
                                  j_alt.lda_project(img, labels))
    np.testing.assert_array_equal(alt.lda_project(img, None),
                                  j_alt.lda_project(img, None))
    got = alt.slic_on_projection(img, labels, 16, 0.075, 10)
    want = j_alt.slic_on_projection(img, labels, 16, 0.075, 10)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def _flax_variables(model: SpixelNet):
    """The port's SpixelNet weights as flax variables (the inverse of
    ``spixelnet_state_dict_from_jax``), without flax's op-by-op init."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}

    def kernel(name):
        return {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{name}.bias"]}

    params, stats = {}, {}
    for name in sorted({k.split(".")[0] for k in sd}):
        if name == "pred" or name.startswith("deconv"):
            i = 4 if name == "pred" else 3 - int(name[len("deconv"):])
            params[f"Conv_{i}"] = kernel(name)
        else:
            params[name] = {"Conv_0": kernel(f"{name}.conv"),
                            "BatchNorm_0": {"scale": sd[f"{name}.bn.weight"],
                                            "bias": sd[f"{name}.bn.bias"]}}
            stats[name] = {"BatchNorm_0": {
                "mean": sd[f"{name}.bn.running_mean"],
                "var": sd[f"{name}.bn.running_var"]}}
    return {"params": params, "batch_stats": stats}


def _randomize(v, rng):
    """Non-identity BatchNorm statistics and affine parameters, drawn as
    ``torch_port_helpers._randomize_bn`` draws them."""
    p, s = v["params"], v["batch_stats"]
    for name, st in s.items():
        bn = {"bn": {**p[name]["BatchNorm_0"], **st["BatchNorm_0"]}}
        bn = _randomize_bn(bn, rng)["bn"]
        p[name]["BatchNorm_0"] = {k: bn[k] for k in ("scale", "bias")}
        st["BatchNorm_0"] = {k: bn[k] for k in ("mean", "var")}
    return v


def test_spixelnet_with_carried_weights_matches_flax():
    """SpixelNet from the port's seeded init, BatchNorm statistics and
    affine parameters drawn with numpy, carried to flax: the
    (B, 9, H, W) softmax of two 64^2 images equals flax's eval forward
    within 1e-5 (f32), and ``spixelnet_state_dict_from_jax`` gives back
    the port's state dict exactly."""
    seeded = SpixelNet(device="cpu", generator=torch.Generator().manual_seed(0))
    v = _randomize(_flax_variables(seeded), np.random.default_rng(1))
    sd = spixelnet_state_dict_from_jax(v)
    model = SpixelNet(device="cpu")
    model.load_state_dict(sd)
    assert _flax_variables(model).keys() == v.keys()
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v_, x_: JaxSpixelNet().apply(
        v_, x_, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 9, 64, 64)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
