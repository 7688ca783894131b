"""The port's sharded programs (tpu_darktable_torch/parallel/) on the CPU,
case by case as tests/test_parallel.py holds the JAX package's.

The port's mesh is `torch.device('cpu')` repeated 2, 4 or 8 times; the JAX
package's runs on the 8 virtual CPU devices of tests/conftest.py.  Each
case holds the port's sharded program against the port's unsharded one
(bit for bit where the gathered samples make it so: batch sharding and the
demosaic; else 1 uint8 count and JAX's bars below) and against the JAX
package's sharded program: 1 uint8 count, bounds atol 1e-6, metrics rtol
1e-5 atol 1e-6 (tests/test_parallel.py's own bars).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpu_darktable as td
from tpu_darktable import parallel as jpar
from tpu_darktable.ops import demosaic as jdem
from tpu_darktable.ops import packed as jpacked
from tpu_darktable.ops import rcd as jrcd
from tpu_darktable.pipeline import ImageProcessor as JProcessor
from tpu_darktable.pipeline.config import Debayer, ImageProcessingSettings, ToneMapper
from tpu_darktable.pipeline.image_processor import build_pipeline_fn as jbuild
from tpu_darktable.pipeline.transform import ImageTransform as JTransform

import tpu_darktable_torch as tt
from tpu_darktable_torch import parallel as tpar
from tpu_darktable_torch.convert import settings_from_dict
from tpu_darktable_torch.ops import demosaic as tdem
from tpu_darktable_torch.ops import rcd as trcd
from tpu_darktable_torch.pipeline.camera_settings import load_camera_settings_from_dir
from tpu_darktable_torch.pipeline.image_processor import build_pipeline_fn as tbuild
from tpu_darktable_torch.pipeline.transform import ImageTransform, transform

torch.set_num_threads(1)
CPU = torch.device('cpu')
WB = (1.2, 1.0, 1.1)


def _settings(**kw):
    defaults = dict(
        debayer=Debayer.rcd, postprocess=True, enable_denoise=True,
        enable_bilateral=True, tone_mapping=ToneMapper.reinhard,
        tone_intensity=2.5, vibrance=0.5,
    )
    defaults.update(kw)
    return ImageProcessingSettings(**defaults)


def _port(js):
    return settings_from_dict(js.model_dump())


def _smooth_mosaic(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.45 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    return np.clip(base + rng.normal(0, 0.03, (h, w)), 0.0, 0.9).astype(np.float32)


def _encode(mosaics, ids=False):
    return np.stack([np.asarray(jpacked.encode12_float(jnp.asarray(m.reshape(-1)), ids_format=ids))
                     for m in mosaics])


def _state_t():
    return (torch.tensor(WB, dtype=torch.float32), torch.zeros(2), torch.zeros(5),
            torch.tensor(1.0))


def _state_j():
    return (jnp.asarray(WB, jnp.float32), jnp.zeros(2, jnp.float32), jnp.zeros(5, jnp.float32),
            jnp.float32(1.0))


def _close(out, ref, bounds=None, ref_bounds=None, metrics=None, ref_metrics=None):
    """JAX's bars: 1 uint8 count, bounds atol 1e-6, metrics rtol 1e-5 atol 1e-6."""
    out, ref = np.asarray(out).astype(int), np.asarray(ref).astype(int)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    diff = np.abs(out - ref)
    assert diff.max() <= 1, (diff.max(), (diff > 1).sum())
    np.testing.assert_allclose(np.asarray(bounds), np.asarray(ref_bounds), atol=1e-6)
    np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref_metrics), rtol=1e-5,
                               atol=1e-6)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- the mesh ----

def test_mesh_shape_and_devices():
    mesh = tpar.make_mesh([CPU] * 8)
    assert mesh.shape == {'batch': 8} and mesh.size == 8
    assert mesh.axis_names == jpar.make_mesh().axis_names
    assert all(d == CPU for d in mesh.devices.ravel())


def test_grid_mesh_shape_guards():
    mesh = tpar.make_grid_mesh(4, 2, [CPU] * 8)
    assert mesh.shape == {'camera': 4, 'band': 2} == jpar.make_grid_mesh(4, 2).shape
    assert mesh.axis_devices('band') == [CPU, CPU]
    with pytest.raises(ValueError, match='need 16 devices') as t_err:
        tpar.make_grid_mesh(4, 4, [CPU] * 8)
    with pytest.raises(ValueError) as j_err:
        jpar.make_grid_mesh(4, 4)
    assert str(t_err.value) == str(j_err.value)


def test_make_mesh_takes_cuda_devices_only():
    """make_mesh() means every CUDA device; it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert tpar.make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tpar.make_mesh()
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tpar.make_grid_mesh(1, 1)


def test_shard_batch_chunks_in_mesh_order():
    mesh = tpar.make_mesh([CPU] * 4)
    x = torch.arange(8 * 3).reshape(8, 3)
    chunks = tpar.shard_batch(x, mesh)
    assert len(chunks) == 4 and all(c.shape == (2, 3) for c in chunks)
    assert torch.equal(torch.cat(chunks), x)
    assert chunks[0].data_ptr() == x.data_ptr()   # on its device already: a view
    with pytest.raises(ValueError, match='does not split'):
        tpar.shard_batch(x[:6], mesh)


# ---- batch sharding ----

def test_batch_sharded_pipeline_matches_single_device(rng):
    h, w, n = 64, 96, 8
    byte_batch = _encode((rng.random((n, h, w)) * 0.8).astype(np.float32))
    js = _settings()
    jfn = jbuild(js, (w, h), td.BayerPattern.RGGB, td.PackedFormat.Packed12,
                 has_white_balance=True)
    jmesh = jpar.make_mesh()
    j_out = jpar.sharded_pipeline(jfn, jmesh)(
        jpar.shard_batch(jnp.asarray(byte_batch), jmesh), *_state_j())

    fn = tbuild(_port(js), (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    mesh = tpar.make_mesh([CPU] * 8)
    single = fn(torch.from_numpy(byte_batch), *_state_t())
    out = tpar.sharded_pipeline(fn, mesh)(tpar.shard_batch(byte_batch, mesh), *_state_t())
    _equal(out, single)   # the gathered samples reduce as the fused program's
    _close(out[0], j_out[0], out[1], j_out[1], out[2], j_out[2])
    with pytest.raises(TypeError):
        tpar.sharded_pipeline(lambda *a: a, mesh)


# ---- the spatial demosaic ----

@pytest.mark.parametrize('algorithm', ['rcd', 'ppg', 'bilinear'])
def test_spatial_sharded_demosaic_matches(rng, algorithm):
    """Bit for bit against the port's unsharded op (RCD with strict_alias
    off); against JAX's spatial demosaic at 1e-6 (the ops tests' bar for
    RCD; JAX's jitted bilinear rounds 1.8e-7 from its eager one, which
    the port equals bit for bit)."""
    h, w = 256, 96
    mosaic = (rng.random((h, w)) * 0.8).astype(np.float32)
    x = torch.from_numpy(mosaic)
    ref = {'rcd': lambda m: trcd.rcd_demosaic(m, tt.BayerPattern.RGGB, strict_alias=False),
           'ppg': lambda m: tdem.ppg_demosaic(m, tt.BayerPattern.RGGB),
           'bilinear': lambda m: tdem.bilinear5x5_demosaic(m, tt.BayerPattern.RGGB)}[algorithm](x)
    out = tpar.spatial_shard_map_demosaic(mosaic, tpar.make_mesh([CPU] * 8), tt.BayerPattern.RGGB,
                                          algorithm=algorithm)
    assert torch.equal(out, ref)
    j_out = np.asarray(jpar.spatial_shard_map_demosaic(
        jnp.asarray(mosaic), jpar.make_mesh(), td.BayerPattern.RGGB, algorithm=algorithm))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=1e-6)


def test_spatial_small_frame_falls_back(rng):
    """A frame smaller than a band's block runs unsharded: the reference's
    own rule."""
    mosaic = (rng.random((64, 64)) * 0.8).astype(np.float32)
    out = tpar.spatial_shard_map_demosaic(mosaic, tpar.make_mesh([CPU] * 8), tt.BayerPattern.RGGB,
                                          algorithm='bilinear')
    assert torch.equal(out, tdem.bilinear5x5_demosaic(torch.from_numpy(mosaic),
                                                      tt.BayerPattern.RGGB))
    j_out = jpar.spatial_shard_map_demosaic(jnp.asarray(mosaic), jpar.make_mesh(),
                                            td.BayerPattern.RGGB, algorithm='bilinear')
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=1e-6)


def test_spatial_demosaic_guards():
    mesh = tpar.make_mesh([CPU] * 8)
    with pytest.raises(ValueError, match='not divisible by 8 shards'):
        tpar.spatial_shard_map_demosaic(np.zeros((100, 64), np.float32), mesh, tt.BayerPattern.RGGB)
    with pytest.raises(ValueError, match='must be even'):
        tpar.spatial_shard_map_demosaic(np.zeros((8 * 33, 64), np.float32), mesh,
                                        tt.BayerPattern.RGGB)
    with pytest.raises(ValueError, match='unknown algorithm'):
        tpar.spatial_shard_map_demosaic(np.zeros((256, 64), np.float32), mesh,
                                        tt.BayerPattern.RGGB, algorithm='vng')


# ---- the spatial pipeline ----

# (settings, Bayer pattern, IDS packing, smooth mosaic): tests/test_parallel.py's
# full-chain, Laplacian, pattern and IDS cases.
SPATIAL_CASES = {
    'full': (dict(), 'RGGB', False, False),
    'laplacian': (dict(enable_denoise=False, enable_bilateral=False, enable_laplacian=True,
                       lap_sigma=0.2, lap_shadows=1.2, lap_highlights=0.8, lap_clarity=0.15),
                  'RGGB', False, True),
    'BGGR': (dict(enable_denoise=False, enable_bilateral=False), 'BGGR', False, True),
    'GRBG': (dict(enable_denoise=False, enable_bilateral=False), 'GRBG', False, True),
    'GBRG': (dict(enable_denoise=False, enable_bilateral=False), 'GBRG', False, True),
    'ids': (dict(enable_denoise=False, enable_bilateral=False, debayer=Debayer.bilinear),
            'RGGB', True, True),
}


@pytest.mark.parametrize('case', list(SPATIAL_CASES))
def test_spatial_pipeline_matches(rng, case):
    """The row-band FULL pipeline on 8 bands against the port's unsharded
    program (strict_alias off) and against JAX's spatial pipeline."""
    kw, pattern, ids, smooth = SPATIAL_CASES[case]
    h, w = 256, 96
    mosaic = _smooth_mosaic(rng, h, w) if smooth else (rng.random((h, w)) * 0.8).astype(np.float32)
    data = _encode([mosaic], ids)[0]
    fmt = 'Packed12_IDS' if ids else 'Packed12'
    js = _settings(**kw)
    j_out = jax.jit(jpar.build_spatial_pipeline_fn(
        js, (w, h), td.BayerPattern[pattern], td.PackedFormat[fmt], True, jpar.make_mesh(),
        halo=64))(jnp.asarray(data), *_state_j())

    ts = _port(js)
    ref = tbuild(ts, (w, h), tt.BayerPattern[pattern], tt.PackedFormat[fmt], True,
                 rcd_strict_alias=False)(torch.from_numpy(data)[None], *_state_t())
    out = tpar.build_spatial_pipeline_fn(
        ts, (w, h), tt.BayerPattern[pattern], tt.PackedFormat[fmt], True,
        tpar.make_mesh([CPU] * 8), halo=64)(torch.from_numpy(data), *_state_t())
    assert out[0].shape == (h, w, 3) and out[0].dtype == torch.uint8
    _close(out[0], ref[0][0], out[1], ref[1], out[2], ref[2])
    _close(out[0], j_out[0], out[1], j_out[1], out[2], j_out[2])


GUARDS = {
    'height': (dict(), (96, 250), 8, 64),
    'alignment': (dict(), (96, 240), 8, 64),
    'halo': (dict(), (96, 256), 8, 60),
    'too small': (dict(), (96, 256), 4, 64 + 64),
    'sigma_s': (dict(bil_sigma_spatial=3.0), (96, 256), 8, 64),
}


@pytest.mark.parametrize('case', list(GUARDS))
def test_spatial_pipeline_guards_carry_jax_messages(case):
    kw, size, n, halo = GUARDS[case]
    js = _settings(**kw)
    with pytest.raises(ValueError) as j_err:
        jpar.build_spatial_pipeline_fn(js, size, td.BayerPattern.RGGB, td.PackedFormat.Packed12,
                                       True, jpar.make_mesh(jax.devices()[:n]), halo=halo)
    with pytest.raises(ValueError) as t_err:
        tpar.build_spatial_pipeline_fn(_port(js), size, tt.BayerPattern.RGGB,
                                       tt.PackedFormat.Packed12, True,
                                       tpar.make_mesh([CPU] * n), halo=halo)
    assert str(t_err.value) == str(j_err.value)


# ---- the camera rig ----

def test_multicamera_rig_batch_sharding(rng):
    """Beetroot's 12 same-geometry cameras over a 4-shard mesh, each
    camera's orientation applied after the program."""
    cams = load_camera_settings_from_dir()['beetroot']
    assert isinstance(cams.transform, dict) and len(cams.transform) == 12
    h, w = 64, 96
    ts = _port(_settings(enable_denoise=False, enable_bilateral=False, postprocess=False,
                         debayer=Debayer.bilinear))
    fn = tbuild(ts, (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True)
    mesh = tpar.make_mesh([CPU] * 4)
    byte_batch = _encode((rng.random((12, h, w)) * 0.8).astype(np.float32))
    out, _, _ = tpar.sharded_pipeline(fn, mesh)(
        tpar.shard_batch(byte_batch, mesh), torch.tensor([1.8, 1.0, 2.1]), torch.zeros(2),
        torch.zeros(5), torch.tensor(1.0))
    assert out.shape == (12, h, w, 3)
    names = [f'cam{i}' for i in range(1, 13)]
    final = {nm: transform(out[i], cams.get_image_transform(nm)) for i, nm in enumerate(names)}
    assert final['cam1'].shape == (w, h, 3)   # rotate_90
    assert final['cam7'].shape == (w, h, 3)   # rotate_270


def test_sharded_image_processor_multicamera(rng):
    """ImageProcessor(mesh=...): a 12-camera set over 4 shards equals the
    unsharded processor bit for bit, and JAX's sharded processor within 1
    count; a batch that does not divide over the mesh raises."""
    h, w = 64, 96
    names = [f'cam{i:02d}' for i in range(12)]
    frames = dict(zip(names, _encode((rng.random((12, h, w)) * 0.8).astype(np.float32))))
    js = _settings()
    jkw = dict(image_size=(w, h), bayer_pattern=td.BayerPattern.RGGB,
               packed_format=td.PackedFormat.Packed12, settings=js, white_balance=WB,
               transforms={n: JTransform.rotate_90 for n in names[:3]}
               | {n: JTransform.none for n in names[3:]})
    jproc = JProcessor(mesh=jpar.make_mesh(jax.devices()[:4]), **jkw)
    j_out = jproc.process_image_set({n: jnp.asarray(f) for n, f in frames.items()})

    tkw = dict(jkw, bayer_pattern=tt.BayerPattern.RGGB, packed_format=tt.PackedFormat.Packed12,
               settings=_port(js),
               transforms={n: ImageTransform.rotate_90 for n in names[:3]}
               | {n: ImageTransform.none for n in names[3:]})
    sharded = tt.ImageProcessor(mesh=tpar.make_mesh([CPU] * 4), **tkw)
    single = tt.ImageProcessor(device='cpu', **tkw)
    assert sharded.device == CPU
    out_s = sharded.process_image_set(frames)
    out_1 = single.process_image_set(frames)
    assert set(out_s) == set(names)
    for n in names:
        assert torch.equal(out_s[n], out_1[n]), n
        assert np.abs(out_s[n].numpy().astype(int) - np.asarray(j_out[n]).astype(int)).max() <= 1
    assert torch.equal(sharded.bounds, single.bounds) and torch.equal(sharded.metrics, single.metrics)
    np.testing.assert_allclose(sharded.bounds.numpy(), np.asarray(jproc.bounds), atol=1e-6)
    np.testing.assert_allclose(sharded.metrics.numpy(), np.asarray(jproc.metrics), rtol=1e-5,
                               atol=1e-6)

    with pytest.raises(ValueError, match='divisible') as t_err:
        sharded.process_batch(np.stack([frames['cam00']] * 5))
    with pytest.raises(ValueError) as j_err:
        jproc.process_batch(jnp.stack([jnp.asarray(frames['cam00'])] * 5))
    assert str(t_err.value) == str(j_err.value)


# ---- camera x band ----

@pytest.mark.parametrize('cam_ways,band_ways,n_frames', [
    (4, 2, 12),  # the beetroot deployment shape: a 12-camera rig on 8 devices
    (2, 2, 4),   # 1 frame per camera group
])
def test_grid_pipeline_matches_unsharded(rng, cam_ways, band_ways, n_frames):
    h, w = 256, 96
    byte_batch = _encode((rng.random((n_frames, h, w)) * 0.8).astype(np.float32))
    js = _settings()
    j_out = jax.jit(jpar.build_grid_pipeline_fn(
        js, (w, h), td.BayerPattern.RGGB, td.PackedFormat.Packed12, True,
        jpar.make_grid_mesh(cam_ways, band_ways), halo=64))(jnp.asarray(byte_batch), *_state_j())

    ts = _port(js)
    ref = tbuild(ts, (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12, True,
                 rcd_strict_alias=False)(torch.from_numpy(byte_batch), *_state_t())
    mesh = tpar.make_grid_mesh(cam_ways, band_ways, [CPU] * 8)
    grid = tpar.build_grid_pipeline_fn(ts, (w, h), tt.BayerPattern.RGGB, tt.PackedFormat.Packed12,
                                       True, mesh, halo=64)
    out = grid(torch.from_numpy(byte_batch), *_state_t())
    assert out[0].shape == (n_frames, h, w, 3)
    _close(out[0], ref[0], out[1], ref[1], out[2], ref[2])
    _close(out[0], j_out[0], out[1], j_out[1], out[2], j_out[2])
    with pytest.raises(ValueError, match='camera groups'):
        grid(torch.from_numpy(byte_batch[:cam_ways + 1]), *_state_t())


@pytest.mark.parametrize('module', ['mesh', 'spatial', 'spatial_pipeline'])
def test_parallel_surface_covers_jax(module):
    """Every public function of the JAX package's parallel/ exists in the
    port with the same parameters in the same order; the package __all__
    agree."""
    import importlib
    import inspect

    assert tpar.__all__ == jpar.__all__
    jmod = importlib.import_module(f'tpu_darktable.parallel.{module}')
    tmod = importlib.import_module(f'tpu_darktable_torch.parallel.{module}')
    for name, obj in vars(jmod).items():
        if name.startswith('_') or getattr(obj, '__module__', None) != jmod.__name__:
            continue
        assert list(inspect.signature(obj).parameters) == \
            list(inspect.signature(getattr(tmod, name)).parameters), name
    assert getattr(tmod, 'DEFAULT_HALO', 64) == getattr(jmod, 'DEFAULT_HALO', 64)
