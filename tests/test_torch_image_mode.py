"""The port's image-fit mode (``neus2_tpu_torch/engine/image_mode.py``)
held against the JAX package's, with the JAX parameters and position draws
carried across.

Tolerances: ``level_tables`` equal; ``hash2d_encode`` within 1e-6 on dense
and hashed levels (both sum the same four corner products in the same
order); the table gradients within 1e-6 of their max (the port sums each
level's 4N updates in one ``index_add_``, JAX adds four scatters); 3 fit
steps: losses rtol 1e-5, MLP leaves within 1e-4 of their max, a table on
all but 0.5% of its entries within 1e-4 of its max and everywhere within
the learning rate (tests/test_torch_testbed_loop.py's rule: with eps 1e-15
Adam turns a gradient of rounding size into a full step); the render within
1e-5.  A small fit on the CPU reaches tests/test_image_mode.py's 26 dB.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neus2_tpu.engine import image_mode as jim
from neus2_tpu_torch import interop, run
from neus2_tpu_torch.engine import image_mode
from neus2_tpu_torch.utils.optim import plain_adam_init
from neus2_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
LR = 5e-3


def target_image(n=96):
    """tests/test_image_mode.py's target: a radial gradient with a hard
    quadrant flip."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    img = np.stack([x, y, np.clip(1.5 * r, 0, 1)], -1)
    img[(x > 0.5) & (y > 0.5)] = 1.0 - img[(x > 0.5) & (y > 0.5)]
    return img.astype(np.float32)


def _small():
    """Levels 0-1 dense, 2-4 hashed (256 rows); level 4's corners reach
    y = 1023, whose product with 2654435761 wraps past 2^32."""
    jcfg = jim.Image2DConfig(n_levels=5, log2_hashmap_size=8, base_resolution=4,
                             per_level_scale=4.0, hidden_dim=16, n_hidden=2, batch_size=512,
                             lr=LR)
    return jcfg, interop.image_config_from_jax(jcfg)


def _params(jcfg):
    jp = jim.init_image_params(jax.random.PRNGKey(0), jcfg)
    # Tables large enough that the encoding matters.
    jp = {"tables": tuple(t * 1e3 for t in jp["tables"]), "mlp": jp["mlp"]}
    return jax.device_get(jp)


def test_level_tables_match_jax():
    for jcfg in (jim.Image2DConfig(), _small()[0]):
        cfg = interop.image_config_from_jax(jcfg)
        assert cfg.level_tables() == jcfg.level_tables()
    tabs = _small()[1].level_tables()
    assert [r * r <= n for r, n in tabs] == [True, True, False, False, False]
    assert tabs[-1][0] - 1 > 2**32 // 2654435761  # the hash wraps past 2^32


def test_hash2d_encode_and_grads_match_jax():
    jcfg, cfg = _small()
    jp = _params(jcfg)
    rng = np.random.default_rng(0)
    # Uniform positions, the far corner and the edges.
    pos = np.concatenate([rng.uniform(size=(1000, 2)),
                          [[1.0, 1.0], [0.0, 1.0], [1.0, 0.0], [0.999, 0.999]]]).astype(np.float32)
    coef = rng.normal(size=(len(pos), 5 * 2)).astype(np.float32)
    jenc = np.asarray(jim.hash2d_encode(jp["tables"], jnp.asarray(pos), jcfg))
    params = interop.image_params_from_jax(jp)
    tables = [t.requires_grad_(True) for t in params["tables"]]
    enc = image_mode.hash2d_encode(tables, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(enc.detach().numpy(), jenc, rtol=0, atol=1e-6)
    jgrads = jax.grad(lambda t: jnp.sum(jim.hash2d_encode(t, jnp.asarray(pos), jcfg) * coef))(
        jp["tables"])
    grads = torch.autograd.grad((enc * torch.from_numpy(coef)).sum(), tables)
    for lvl, (g, jg) in enumerate(zip(grads, jgrads)):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, lvl
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-6 * np.abs(jg).max(),
                                   err_msg=str(lvl))


def test_fit_steps_and_render_match_jax():
    jcfg, cfg = _small()
    img = target_image(48)
    jp = _params(jcfg)
    jopt = jim.make_image_optimizer(jcfg).init(jp)
    params = interop.image_params_from_jax(jp)
    opt = plain_adam_init(params)
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        key, k = jax.random.split(key)
        pos = torch.from_numpy(np.array(jax.random.uniform(k, (jcfg.batch_size, 2))))
        jp, jopt, jloss = jim.image_fit_step(jp, jopt, k, jnp.asarray(img), jcfg)
        params, opt, loss = image_mode.image_fit_step(params, opt, torch.from_numpy(img), cfg,
                                                      pos=pos)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jp = jax.device_get(jp)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for name, a, b in zip(paths, jax.tree_util.tree_leaves(jp), tree_leaves(params)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        diff = np.abs(b - a)
        bound = 1e-4 * max(np.abs(a).max(), 1e-12)
        if "tables" in name:
            assert (diff > bound).mean() <= 0.005, name
            assert diff.max() <= LR * 1.001, name
        else:
            assert diff.max() <= bound, name
    params = interop.image_params_from_jax(jp)
    rec = image_mode.render_image_fit(params, cfg, (40, 30), chunk=512).numpy()
    jrec = np.asarray(jim.render_image_fit(jp, jcfg, (40, 30)))
    assert rec.shape == (30, 40, 3)
    np.testing.assert_allclose(rec, jrec, rtol=0, atol=1e-5)


def test_fit_image_reaches_jax_bar():
    """tests/test_image_mode.py::test_image_fit_converges' config, bar and
    edge check, in 400 port steps on the CPU."""
    img = target_image()
    cfg = interop.image_config_from_jax(jim.Image2DConfig(
        n_levels=6, log2_hashmap_size=12, base_resolution=4, per_level_scale=2.0,
        hidden_dim=32, n_hidden=2, batch_size=4096, lr=5e-3))
    params, psnr = image_mode.fit_image(img, n_steps=400, config=cfg, verbose=False,
                                        device="cpu")
    assert psnr > 26.0, psnr
    recon = image_mode.render_image_fit(params, cfg, (96, 96)).numpy()
    assert abs(recon[80, 80, 0] - img[80, 80, 0]) < 0.15


def test_fit_image_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        image_mode.fit_image(target_image(8), n_steps=1)


def test_cli_image_mode(tmp_path):
    """``--mode image`` on a small PNG at the default width: the eval json
    and the reconstruction written, the PSNR the Python API's."""
    img = target_image(32)
    png = tmp_path / "img.png"
    Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(png)
    res = run.main(["--mode", "image", "--scene", str(png), "--device", "cpu", "--n_steps", "3",
                    "--output_dir", str(tmp_path / "out"), "--name", "i"])
    out = tmp_path / "out" / "i"
    ev = json.loads((out / "logs" / "image_eval.json").read_text())
    loaded = run._read_image(png)
    assert loaded.shape == (32, 32, 3) and loaded.max() <= 1.0
    _, psnr = image_mode.fit_image(loaded, n_steps=3, verbose=False, device="cpu")
    assert ev == {"steps": 3, "psnr": psnr} and res["psnr"] == psnr
    assert res["config"] == image_mode.Image2DConfig()
    with Image.open(out / "image_recon.png") as im:
        assert im.size == (32, 32) and im.mode == "RGB"
