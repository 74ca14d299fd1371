"""Reader for the reference's original TFRecord training data (needs
TensorFlow, imported inside the calls).

The PyTorch port of stabnet_tpu/compat/tfrecord.py.  Schema (reference:
get_data_mini_after.py:168-176): each example stores frame PATHS (stable
and unstable frame directories), the sample position, a dense flow map and
two variable-length feature-match lists.  This reader decodes the JPEGs
the records name and yields raw examples in the record layout
(data/records.py), so `convert_dataset` turns a DeepStab TFRecord dataset
into the shard format either package trains on.  The JPEG decode, the gray
conversion and the bilinear resize are TensorFlow's own, as in the
reference.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from stabnet_tpu_torch.config import StabNetConfig
from stabnet_tpu_torch.data.records import write_shards


def _tf():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError("TensorFlow required to read reference TFRecords") from e
    return tf


def _decode_gray(tf, path: str, height: int, width: int) -> np.ndarray:
    """JPEG -> (H, W) float32 in [-0.5, 0.5] (reference: get_img,
    get_data_mini_after.py:149-156)."""
    img = tf.io.decode_jpeg(tf.io.read_file(path))
    img = tf.image.rgb_to_grayscale(img)
    img = tf.image.convert_image_dtype(img, tf.float32)
    img = tf.image.resize(img, (height, width), method="bilinear")
    return np.asarray(img)[..., 0] - 0.5


def _to_u8(stack: List[np.ndarray]) -> np.ndarray:
    arr = np.stack(stack, axis=-1)
    return np.clip(np.round((arr + 0.5) * 255.0), 0, 255).astype(np.uint8)


def iterate_reference_examples(record_dir: str, cfg: StabNetConfig
                               ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield raw examples from a reference-format record directory.

    `record_dir` holds `list.txt`, which names the TFRecord files
    (reference: get_data_mini_after.py:158-163); the frame paths stored in
    the records must resolve.
    """
    tf = _tf()
    with open(os.path.join(record_dir, "list.txt")) as f:
        files = [os.path.join(record_dir, n.strip()) for n in f.read().split()]

    feature_spec = {
        "stable_path": tf.io.FixedLenFeature([], tf.string),
        "unstable_path": tf.io.FixedLenFeature([], tf.string),
        "pos": tf.io.FixedLenFeature([], tf.int64),
        "flow": tf.io.VarLenFeature(tf.float32),
        "feature_matches1": tf.io.VarLenFeature(tf.float32),
        "feature_matches2": tf.io.VarLenFeature(tf.float32),
    }

    for rec in tf.data.TFRecordDataset(files):
        ex = tf.io.parse_single_example(rec, feature_spec)
        pos = int(ex["pos"])
        stable_path = ex["stable_path"].numpy().decode()
        unstable_path = ex["unstable_path"].numpy().decode()

        def img(base, t):
            return _decode_gray(tf, f"{base}{t}.jpg", cfg.height, cfg.width)

        stable = [img(stable_path, base - i)
                  for base in (pos - 1, pos) for i in cfg.indices if i >= 0]
        unstable = [img(unstable_path, base - i)
                    for base in (pos - 1, pos) for i in cfg.indices if i <= 0]
        flow = tf.sparse.to_dense(ex["flow"]).numpy().reshape(
            cfg.height, cfg.width, -1)[:, :, :2]

        def matches(key):
            m = tf.sparse.to_dense(ex[key]).numpy().reshape(-1, 4)
            if m.shape[0] >= cfg.max_matches:
                raise ValueError(f"{key}: {m.shape[0]} matches, more than "
                                 f"max_matches {cfg.max_matches} - 1")
            out = np.zeros((cfg.max_matches, 4), np.float32)
            out[: m.shape[0]] = m
            mask = np.zeros((cfg.max_matches,), np.bool_)
            mask[: m.shape[0]] = True
            return out, mask

        m1, k1 = matches("feature_matches1")
        m2, k2 = matches("feature_matches2")
        yield {
            "stable": _to_u8(stable),
            "unstable": _to_u8(unstable),
            "flow": flow.astype(np.float32),
            "matches1": m1, "mask1": k1, "matches2": m2, "mask2": k2,
        }


def convert_dataset(record_dir: str, out_dir: str, cfg: StabNetConfig,
                    limit: Optional[int] = None) -> int:
    """Reference TFRecords -> the record shards; returns the example count."""
    examples = []
    for i, ex in enumerate(iterate_reference_examples(record_dir, cfg)):
        examples.append(ex)
        if limit is not None and i + 1 >= limit:
            break
    write_shards(out_dir, examples)
    return len(examples)
