"""The port's C++ image transform (robustvlm_tpu_torch.data.native, built
from csrc/image_ops.cpp) against the JAX package's (native/image_ops.cpp)
and PIL.

- The port's transform gives JAX's native transform's bits: the same source
  built with the same flags (resize, center crop, layout conversion; RGB,
  L and RGBA images; down- and upscaling).
- Against PIL's bicubic resize, as JAX's own test holds its transform: at
  most 3/255 a pixel (PIL rounds its horizontal pass to uint8) and 1/255 on
  average; the whole transform against its PIL path within 1/255 on
  average and 1.5/255 at most.
- `default_image_transform` takes the C++ transform when it builds, PIL
  with `prefer_native=False`; the library is built under build/native/.
"""

import time

import numpy as np
import pytest
from PIL import Image

from robustvlm_tpu.data import native as jax_native
from robustvlm_tpu_torch.data import loaders, native


def jax_native_transform(size: int):
    """JAX's C++ transform. Its library is built by `make` at first use, by
    every test process at once: a load that lost that race is retried."""
    for _ in range(5):
        tf = jax_native.native_image_transform(size)
        if tf is not None:
            return tf
        jax_native._load_failed = False
        time.sleep(1.0)
    pytest.skip("the JAX package's native image library could not be built")


def port_native_transform(size: int):
    tf = native.native_image_transform(size)
    assert tf is not None, native.BUILD_LOG
    return tf


def _img(seed, h, w, mode="RGB"):
    arr = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    return Image.fromarray(arr).convert(mode)


@pytest.mark.parametrize("h,w,size", [(97, 131, 64), (40, 40, 32), (20, 24, 48), (300, 200, 224)])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_transform_bit_equal_to_jax_native(h, w, size, mode):
    img = _img(h + w, h, w, mode)
    ours = port_native_transform(size)(img)
    theirs = jax_native_transform(size)(img)
    assert ours.shape == (3, size, size) and ours.dtype == np.float32
    assert np.array_equal(ours, theirs)


def test_ops_bit_equal_to_jax_native():
    jax_native_transform(32)  # built
    arr = np.random.RandomState(4).randint(0, 256, (37, 53, 3), np.uint8)
    assert np.array_equal(native.resize_bicubic(arr, 20, 30), jax_native.resize_bicubic(arr, 20, 30))
    assert np.array_equal(native.resize_center_crop(arr, 24), jax_native.resize_center_crop(arr, 24))
    assert np.array_equal(native.to_chw_f32(arr), jax_native.to_chw_f32(arr))
    np.testing.assert_allclose(native.to_chw_f32(arr), arr.transpose(2, 0, 1) / 255.0, atol=1e-6)


@pytest.mark.parametrize("h,w,dh,dw", [(97, 131, 48, 64), (20, 24, 40, 48)])
def test_resize_within_pil(h, w, dh, dw):
    arr = np.random.RandomState(h).randint(0, 256, (h, w, 3), np.uint8)
    ours = native.resize_bicubic(arr, dh, dw)
    ref = np.asarray(Image.fromarray(arr).resize((dw, dh), Image.BICUBIC), np.float32).transpose(2, 0, 1) / 255.0
    assert float(np.abs(ours - ref).max()) <= 3.0 / 255.0 + 1e-6
    assert float(np.abs(ours - ref).mean()) <= 1.0 / 255.0


@pytest.mark.parametrize("h,w,size", [(45, 61, 32), (300, 200, 224), (500, 375, 224)])
def test_default_transform_takes_native_and_pil_on_request(h, w, size):
    """The whole transform (shorter-side resize, center crop) against its
    PIL path: within 1/255 on average and 1.5/255 at most. PIL rounds its
    horizontal pass and its output to uint8 (each half a level at most);
    the C++ transform keeps float32 throughout."""
    img = _img(h, h, w)
    tf = loaders.default_image_transform(size)
    assert getattr(tf, "native", False)
    pil = loaders.default_image_transform(size, prefer_native=False)
    assert not getattr(pil, "native", False)
    a, b = tf(img), pil(img)
    assert float(np.abs(a - b).mean()) <= 1.0 / 255.0
    assert float(np.abs(a - b).max()) <= 1.5 / 255.0
    assert native.library_path().exists() and native.library_path().parent.name == "native"


def test_bad_input_raises():
    with pytest.raises(ValueError, match="uint8 HWC"):
        native.to_chw_f32(np.zeros((4, 4), np.uint8))
