"""Host-side image codec — counterpart of ``mxnet_tpu/image_backend.py``.

The reference decodes with OpenCV (src/io/image_io.cc).  As in the JAX
package, single images are encoded, decoded and resized on the host by
PIL, so the two packages give the same pixels.  Where PIL is missing, a
JPEG goes through the native codec instead (``native.decode_jpeg_batch``:
libjpeg's ``src/imgdecode.cc``, or nvJPEG's ``csrc/nvjpeg_codec.cu`` on a
machine with CUDA but no libjpeg headers; ``native.encode_jpeg``: nvJPEG),
and ``codec_routes`` says which one each direction takes.  Decoded images
are HWC uint8 numpy arrays in RGB order.
"""
from __future__ import annotations

import io

import numpy as np

__all__ = ["decode_image", "encode_image", "resize_image", "HAVE_PIL",
           "codec_routes"]

try:
    from PIL import Image

    HAVE_PIL = True
except ImportError:  # pragma: no cover
    HAVE_PIL = False

_JPEG = (".jpg", ".jpeg")


def codec_routes() -> dict:
    """Which codec encodes a JPEG, which decodes one image
    (``decode_image``) and which decodes a batch
    (``native.decode_jpeg_batch``; None: the iterators decode with
    ``decode_image``)."""
    from . import native

    pil = "PIL %s" % Image.__version__ if HAVE_PIL else None
    batch = native.decoder_route()
    return {"encode": pil or ("nvjpeg" if native.nvjpeg_lib() else None),
            "decode": pil or batch, "batch_decode": batch}


def _native_decode(buf):
    from . import native

    arr = native.decode_jpeg_batch([buf])[0]
    if arr is None:
        raise RuntimeError(
            "No image decode backend available: PIL is missing and the "
            "native JPEG decoder (%s) could not decode this buffer"
            % (native.decoder_route() or native.native_status()))
    return arr


def decode_image(buf, channels: int = 3) -> np.ndarray:
    """Decode an encoded image buffer to HWC uint8 (RGB order, matching the
    reference's to_rgb=True default in imdecode)."""
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    if not HAVE_PIL:
        if channels != 3:
            raise RuntimeError("No grayscale decode backend available "
                               "(PIL missing)")
        return _native_decode(bytes(buf))
    img = Image.open(io.BytesIO(buf))
    if channels == 3:
        img = img.convert("RGB")
    elif channels == 1:
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def encode_image(arr: np.ndarray, img_fmt: str = ".jpg",
                 quality: int = 95) -> bytes:
    """Encode an HWC uint8 array to JPEG/PNG bytes (reference pack_img uses
    OpenCV imencode)."""
    jpeg = img_fmt.lower() in _JPEG
    if not HAVE_PIL:
        from . import native

        if jpeg and native.nvjpeg_lib() is not None:
            return native.encode_jpeg(arr, quality)
        raise RuntimeError("No image encode backend available (PIL missing)")
    fmt = "JPEG" if jpeg else "PNG"
    img = Image.fromarray(arr[..., 0] if arr.ndim == 3 and arr.shape[-1] == 1
                          else arr)
    out = io.BytesIO()
    if fmt == "JPEG":
        img.save(out, fmt, quality=quality)
    else:
        img.save(out, fmt)
    return out.getvalue()


def resize_image(arr: np.ndarray, w: int, h: int,
                 interp: int = 1) -> np.ndarray:
    """Resize HWC preserving dtype: uint8 goes through PIL directly; float
    images are resized per-channel in 'F' mode (PIL has no float RGB mode) —
    no wrapping casts."""
    if not HAVE_PIL:
        raise RuntimeError("No image resize backend available (PIL missing)")
    interp_map = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                  3: Image.NEAREST, 4: Image.LANCZOS}
    mode = interp_map.get(interp, Image.BILINEAR)
    if np.issubdtype(arr.dtype, np.floating):
        chans = [np.asarray(Image.fromarray(
            arr[:, :, c].astype(np.float32), mode="F").resize((w, h), mode))
            for c in range(arr.shape[-1])]
        return np.stack(chans, axis=-1).astype(arr.dtype, copy=False)
    img = Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr)
    img = img.resize((w, h), mode)
    out = np.asarray(img)
    if out.ndim == 2:
        out = out[:, :, None]
    return out
