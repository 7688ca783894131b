"""The port's pipeline helpers against the JAX package's, on the CPU:
transform (next_rotation, transformed_size), util (resize, resize_image:
1e-6), the config validators (get_validator, coerce, serialize, clamp), the
raw loaders and camera resolution of camera_settings, and where the port
builds its libraries outside a checkout."""

import dataclasses
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_darktable.ops import packed as jpacked
from tpu_darktable.ops.bayer import BayerPattern as JPattern
from tpu_darktable.ops.bayer import PackedFormat as JFormat
from tpu_darktable.pipeline import camera_settings as jcam
from tpu_darktable.pipeline import config as jconfig
from tpu_darktable.pipeline import util as jutil

import tpu_darktable_torch as tt
from tpu_darktable_torch import _paths
from tpu_darktable_torch.pipeline import camera_settings as tcam
from tpu_darktable_torch.pipeline import config as tconfig
from tpu_darktable_torch.pipeline import util as tutil

# pipeline/__init__ exports the function `transform` over its module's name
jtransform = importlib.import_module('tpu_darktable.pipeline.transform')
ttransform = importlib.import_module('tpu_darktable_torch.pipeline.transform')
torch.set_num_threads(1)


# ---- transform ----

@pytest.mark.parametrize('name', [m.name for m in jtransform.ImageTransform])
def test_next_rotation_and_transformed_size_vs_jax(name):
    j_tf, t_tf = jtransform.ImageTransform[name], ttransform.ImageTransform[name]
    assert t_tf.next_rotation().name == j_tf.next_rotation().name
    for size in ((6, 4), (4096, 3000)):
        assert ttransform.transformed_size(size, t_tf) == jtransform.transformed_size(size, j_tf)
    assert tt.pipeline.transformed_size is ttransform.transformed_size


# ---- util ----

@pytest.mark.parametrize('size', [(48, 80), (37, 61), (30, 50), (7, 300), (192, 320),
                                  (96, 200), (101, 161), (150, 100)])
def test_resize_vs_jax(size):
    """Bilinear resize with half-pixel centres, antialiased along an axis
    that shrinks: down, up and mixed scales within 1e-6 of
    jax.image.resize(method='linear')."""
    x = np.random.default_rng(0).random((96, 160, 3)).astype(np.float32)
    ref = np.asarray(jutil.resize(jnp.asarray(x), size))
    out = tutil.resize(torch.from_numpy(x), size).numpy()
    assert out.shape == ref.shape == (*size, 3)
    assert np.abs(out - ref).max() <= 1e-6


@pytest.mark.parametrize('longest', [0, 64, 100, 333])
def test_resize_image_vs_jax(longest):
    x = np.random.default_rng(1).random((96, 160, 3)).astype(np.float32)
    ref = np.asarray(jutil.resize_image(jnp.asarray(x), longest))
    out = tutil.resize_image(torch.from_numpy(x), longest).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-6


# ---- config ----

def _validator_facts(v):
    if v is None:
        return None
    facts = dict(cls=type(v).__name__, description=v.description,
                 range=getattr(v, 'range', None), step=getattr(v, 'step', None))
    if hasattr(v, 'enum_type'):
        facts['enum'] = [(m.name, m.value) for m in v.enum_type]
    return facts


@pytest.mark.parametrize('name', [*jconfig.ImageProcessingSettings.model_fields, 'no_such_field'])
def test_get_validator_vs_jax(name):
    """Every field: the same validator class, range, description, step
    and enum members, or None on both sides."""
    j = jconfig.get_validator(jconfig.ImageProcessingSettings, name)
    t = tconfig.get_validator(tconfig.ImageProcessingSettings, name)
    assert _validator_facts(t) == _validator_facts(j)


_COERCE = {
    'tone_gamma': [0.75, 5.0, 0.05, 9.0, '2.5', 'abc', 3],
    'denoise_overlap': [2, 8, 1, 9, 4.7, '6'],
    'resize_width': [0, 4096, -1, 4097],
    'enable_denoise': [True, 0, 'yes', None],
    'debayer': ['rcd', 'ppg', 'nope', 2, 'bilinear'],
    'tone_mapping': ['filmic', 'adaptive_aces', 'ACES', 1.0],
}


def _outcome(validator, value):
    try:
        out = validator.coerce(value)
    except Exception as e:  # noqa: BLE001  (the type is what is compared)
        return type(e).__name__
    return (type(out).__name__, getattr(out, 'name', out))


@pytest.mark.parametrize('name', list(_COERCE))
def test_coerce_vs_jax(name):
    """coerce returns the same value, or raises the same error, as JAX's;
    EnumValidator serializes members and dict-of-member maps as JAX's."""
    j = jconfig.get_validator(jconfig.ImageProcessingSettings, name)
    t = tconfig.get_validator(tconfig.ImageProcessingSettings, name)
    for value in _COERCE[name]:
        assert _outcome(t, value) == _outcome(j, value), value
    if isinstance(t, tconfig.EnumValidator):
        member = next(iter(t.enum_type))
        assert t.serialize(member) == j.serialize(j.enum_type[member.name])
        assert t.serialize({'a': member}) == j.serialize({'a': j.enum_type[member.name]})


def test_settings_reject_what_jax_rejects():
    """The settings check every field through its validator: what JAX's
    model rejects raises ValueError naming the field, and an unknown enum
    name the enum's KeyError, as in JAX; enum names coerce."""
    for bad in (dict(tone_gamma=9.0), dict(denoise_overlap=1), dict(vibrance=-2),
                dict(resize_width=5000), dict(tone_mapping=7)):
        with pytest.raises(ValueError):
            jconfig.ImageProcessingSettings(**bad)
        with pytest.raises(ValueError, match=next(iter(bad))):
            tconfig.ImageProcessingSettings(**bad)
    for model in (jconfig.ImageProcessingSettings, tconfig.ImageProcessingSettings):
        with pytest.raises(KeyError, match='nope'):
            model(debayer='nope')
    s = tconfig.ImageProcessingSettings(debayer='ppg', tone_mapping='filmic', denoise_overlap='2')
    assert (s.debayer, s.tone_mapping, s.denoise_overlap) == \
        (tconfig.Debayer.ppg, tconfig.ToneMapper.filmic, 2)
    assert dataclasses.replace(s, bilateral=1).bilateral == 1.0


@pytest.mark.parametrize('x,lo,hi', [(5, 0, 10), (-1, 0, 10), (11, 0, 10), (0.5, 0.6, 0.7),
                                     (3, 3, 3)])
def test_clamp_vs_jax(x, lo, hi):
    assert tconfig.clamp(x, lo, hi) == jconfig.clamp(x, lo, hi)


# ---- camera_settings ----

def _cams(padding, fmt='Packed12', pattern='BGGR', size=(96, 64)):
    ips = dict(enable_denoise=False)
    j = jcam.CameraSettings(name='testcam', image_size=size, padding=padding,
                            bayer_pattern=JPattern[pattern], packed_format=JFormat[fmt],
                            image_processing=jconfig.ImageProcessingSettings(**ips))
    t = tcam.CameraSettings(name='testcam', image_size=size, padding=padding,
                            bayer_pattern=pattern, packed_format=fmt,
                            image_processing=tconfig.ImageProcessingSettings(**ips))
    return j, t


@pytest.mark.parametrize('padding,fmt', [(0, 'Packed12'), (16, 'Packed12'),
                                         (24, 'Packed12_IDS')])
def test_raw_loaders_vs_jax(tmp_path, padding, fmt):
    """load_raw_bytes, load_raw_bytes_stripped and load_raw_bayer on a
    written file: equal to JAX's, with and without padding."""
    w, h = 96, 64
    rng = np.random.default_rng(padding)
    mosaic = (rng.random(h * w) * 0.9).astype(np.float32)
    data = np.asarray(jpacked.encode12_float(jnp.asarray(mosaic), ids_format=fmt.endswith('IDS')))
    path = tmp_path / 'frame.raw'
    path.write_bytes(np.concatenate([data, rng.integers(0, 256, padding, dtype=np.uint8)]))
    jc, tc = _cams(padding, fmt)
    assert tc.bytes == jc.bytes == path.stat().st_size
    raw = tcam.load_raw_bytes(path, device='cpu')
    assert raw.dtype == torch.uint8 and raw.device.type == 'cpu'
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jcam.load_raw_bytes(path)))
    np.testing.assert_array_equal(tcam.load_raw_bytes_stripped(path, tc, device='cpu').numpy(),
                                  np.asarray(jcam.load_raw_bytes_stripped(path, jc)))
    bayer = tcam.load_raw_bayer(path, tc, device='cpu')
    assert tuple(bayer.shape) == (h, w) and bayer.dtype == torch.float32
    np.testing.assert_array_equal(bayer.numpy(), np.asarray(jcam.load_raw_bayer(path, jc)))


def test_raw_loaders_default_to_the_card(tmp_path):
    path = tmp_path / 'x.raw'
    path.write_bytes(bytes(12))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            tcam.load_raw_bytes(path)


def test_settings_for_file_vs_jax(tmp_path):
    """By directory name, then by file size (a sparse file of beetroot's
    size: the first camera of that size in name order), and JAX's error
    when neither matches; load_raw_bayer resolves the camera itself."""
    by_dir = tmp_path / 'pfr' / 'frame.raw'
    by_dir.parent.mkdir()
    by_dir.write_bytes(bytes(10))
    assert tcam.settings_for_file(by_dir).to_dict() == \
        jcam.settings_for_file(by_dir).model_dump(mode='json')
    by_size = tmp_path / 'unknown' / 'frame.raw'
    by_size.parent.mkdir()
    with open(by_size, 'wb') as f:
        f.truncate(tcam.load_camera_settings_from_dir()['beetroot'].bytes)
    t, j = tcam.settings_for_file(by_size), jcam.settings_for_file(by_size)
    assert t.name == j.name == 'beetroot'
    assert t.to_dict() == j.model_dump(mode='json')
    np.testing.assert_array_equal(tcam.load_raw_bayer(by_size, device='cpu').numpy(),
                                  np.asarray(jcam.load_raw_bayer(by_size)))
    stray = tmp_path / 'unknown' / 'short.raw'
    stray.write_bytes(bytes(100))
    with pytest.raises(ValueError) as t_err:
        tcam.settings_for_file(stray)
    with pytest.raises(ValueError) as j_err:
        jcam.settings_for_file(stray)
    assert str(t_err.value) == str(j_err.value)


def test_validate_camera_names_vs_jax():
    """beetroot's per-camera transform map: its own twelve names pass, a
    missing or extra name raises JAX's message; a single transform accepts
    any names."""
    t_cam = tcam.load_camera_settings_from_dir()['beetroot']
    j_cam = jcam.load_camera_settings_from_dir()['beetroot']
    names = [f'cam{i}' for i in range(1, 13)]
    assert isinstance(t_cam.transform, dict) and set(t_cam.transform) == set(names)
    tcam.validate_camera_names(t_cam, names)
    jcam.validate_camera_names(j_cam, names)
    for bad in (names[:-1], names + ['cam13']):
        with pytest.raises(ValueError) as t_err:
            tcam.validate_camera_names(t_cam, bad)
        with pytest.raises(ValueError) as j_err:
            jcam.validate_camera_names(j_cam, bad)
        assert str(t_err.value) == str(j_err.value)
    tcam.validate_camera_names(tcam.load_camera_settings_from_dir()['pfr'], ['anything'])


def test_camera_settings_coerce_through_validators():
    """The enum fields take names or members, as JAX's EnumValidator
    fields do, and reject what it rejects."""
    jc, tc = _cams(0, pattern='GRBG')
    assert tc.bayer_pattern is tt.BayerPattern.GRBG
    assert tc.to_dict() == jc.model_dump(mode='json')
    per_cam = dataclasses.replace(tc, transform={'a': 'rotate_90', 'b': ttransform.ImageTransform.none})
    assert per_cam.get_image_transform('a') is ttransform.ImageTransform.rotate_90
    assert tcam.CameraSettings.from_dict(per_cam.to_dict()) == per_cam
    with pytest.raises(KeyError):
        dataclasses.replace(tc, bayer_pattern='XYZW')
    with pytest.raises(ValueError, match='bayer_pattern'):
        dataclasses.replace(tc, bayer_pattern=3)


# ---- where the libraries are built ----

def test_build_root_outside_a_checkout(tmp_path, monkeypatch):
    """In a checkout: build/<kind> at its root.  An installed package (no
    pyproject.toml beside it) builds into the user cache directory;
    TD_TORCH_BUILD_DIR overrides both."""
    monkeypatch.delenv('TD_TORCH_BUILD_DIR', raising=False)
    assert _paths.build_root('kernels') == _paths.PACKAGE.parent / 'build' / 'kernels'
    monkeypatch.setattr(_paths, 'PACKAGE', tmp_path / 'site-packages' / 'tpu_darktable_torch')
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    root = _paths.build_root('native')
    assert root == tmp_path / 'cache' / 'tpu_darktable_torch' / 'native' and root.is_dir()
    monkeypatch.setenv('TD_TORCH_BUILD_DIR', str(tmp_path / 'override'))
    assert _paths.build_root('kernels') == tmp_path / 'override'


@pytest.mark.parametrize('name', ['config', 'camera_settings', 'transform', 'util'])
def test_public_names_cover_jax(name):
    """Every public function and class the JAX module defines exists in
    the port's counterpart."""
    j = importlib.import_module(f'tpu_darktable.pipeline.{name}')
    t = importlib.import_module(f'tpu_darktable_torch.pipeline.{name}')
    defined = [k for k, v in vars(j).items() if not k.startswith('_')
               and getattr(v, '__module__', None) == j.__name__]
    assert defined and [k for k in defined if not hasattr(t, k)] == []
