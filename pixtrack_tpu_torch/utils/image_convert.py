"""Batch image-format conversion (the HEIC->PNG notebook's role).

Port of ``pixtrack_tpu/utils/image_convert.py``, with the same behaviour:
walk a source folder, decode every image (HEIC included, when a decoder is
present), and write them to a target folder in the requested format. HEIC
decoding is gated: ``pillow_heif`` / ``pyheif`` are registered with PIL when
importable, and otherwise decoding a HEIC file raises a clear error naming
the options; everything else (the conversion loop, the other formats, the
CLI) works without them. PIL and the decoders are imported inside the
functions that use them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

_HEIC_EXTS = {".heic", ".heif"}


def _enable_heif_if_possible() -> Optional[str]:
    """Register a HEIF decoder with PIL. Returns the backend name or None."""
    try:
        import pillow_heif  # type: ignore

        pillow_heif.register_heif_opener()
        return "pillow_heif"
    except ImportError:
        pass
    try:  # the reference notebook's own decoder (Convert_HEIC_to_PNG.ipynb)
        import pyheif  # type: ignore  # noqa: F401

        return "pyheif"
    except ImportError:
        return None


def _decode(path: Path, backend: Optional[str]):
    """Decode one image to a PIL.Image (RGB)."""
    from PIL import Image

    if path.suffix.lower() in _HEIC_EXTS:
        if backend is None:
            raise RuntimeError(
                f"cannot decode {path.name}: no HEIF decoder available "
                "(install pillow_heif or pyheif, or pre-convert with "
                "`heif-convert`)"
            )
        if backend == "pyheif":
            import pyheif  # type: ignore

            f = pyheif.read(path)
            return Image.frombytes(f.mode, f.size, f.data, "raw", f.mode,
                                   f.stride)
    return Image.open(path).convert("RGB")


def convert_images(
    src_dir,
    out_dir,
    to: str = "png",
    exts: Optional[Iterable[str]] = None,
) -> int:
    """Convert every image under ``src_dir`` (non-recursive) to ``to`` format
    in ``out_dir``. Returns the number of images written.

    ``exts``: restrict to these source extensions (default: heic/heif/jpg/
    jpeg/png/bmp/tiff — skipping files already in the target format, as the
    notebook does by converting only the HEIC set).
    """
    src_dir, out_dir = Path(src_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    to = to.lower().lstrip(".")
    if exts is None:
        exts = {".heic", ".heif", ".jpg", ".jpeg", ".png", ".bmp", ".tiff"}
        exts.discard("." + to)
    else:
        exts = {("." + e.lower().lstrip(".")) for e in exts}
    backend = _enable_heif_if_possible()
    n = 0
    for p in sorted(src_dir.iterdir()):
        if not p.is_file() or p.suffix.lower() not in exts:
            continue
        img = _decode(p, backend)
        save_kw = {"quality": 95} if to in ("jpg", "jpeg") else {}
        img.save(out_dir / (p.stem + "." + to), **save_kw)
        n += 1
    return n
