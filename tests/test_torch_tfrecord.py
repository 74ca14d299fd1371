"""The port's reader of the reference's TFRecord datasets against the JAX
package's, on the CPU (needs TensorFlow).

A two-record reference-format directory (`list.txt`, JPEG frames written by
`tf.io.encode_jpeg`, a dense flow field and variable-length match lists,
reference get_data_mini_after.py:158-176): both packages'
`iterate_reference_examples` give equal examples, and `convert-data`
through both CLIs writes equal shards, bit for bit (the decode, the gray
conversion and the resize are TensorFlow's in both).
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from stabnet_tpu.cli.main import main as jax_cli
from stabnet_tpu.compat.tfrecord import iterate_reference_examples as jax_iterate
from stabnet_tpu.config import get_config as jax_config
from stabnet_tpu_torch.cli.main import main as cli
from stabnet_tpu_torch.compat import iterate_reference_examples
from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.data.records import list_shards, read_shard

FRAME_HW = (60, 80)             # decoded size; resized to TINY's 48x64
RECORDS = ((5, 3, 7), (9, 12, 1))  # (pos, matches in list 1, in list 2)


def _floats(a):
    return tf.train.Feature(float_list=tf.train.FloatList(value=np.ravel(a).tolist()))


def _bytes(s):
    return tf.train.Feature(bytes_list=tf.train.BytesList(value=[s.encode()]))


@pytest.fixture(scope="module")
def record_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tfrecords")
    cfg = get_config("tiny")
    rng = np.random.RandomState(0)
    bases = {}
    for kind in ("stable", "unstable"):
        d = root / kind / "clip0"
        os.makedirs(d)
        for t in range(12):
            img = rng.randint(0, 256, FRAME_HW + (3,), dtype=np.uint8)
            tf.io.write_file(str(d / f"{t}.jpg"), tf.io.encode_jpeg(img))
        bases[kind] = str(d) + os.sep
    with tf.io.TFRecordWriter(str(root / "part-0.tfrecord")) as w:
        for pos, n1, n2 in RECORDS:
            flow = rng.uniform(-1, 1, (cfg.height, cfg.width, 2)).astype(np.float32)
            ex = tf.train.Example(features=tf.train.Features(feature={
                "stable_path": _bytes(bases["stable"]),
                "unstable_path": _bytes(bases["unstable"]),
                "pos": tf.train.Feature(int64_list=tf.train.Int64List(value=[pos])),
                "flow": _floats(flow),
                "feature_matches1": _floats(rng.uniform(-1, 1, (n1, 4))),
                "feature_matches2": _floats(rng.uniform(-1, 1, (n2, 4))),
            }))
            w.write(ex.SerializeToString())
    (root / "list.txt").write_text("part-0.tfrecord\n")
    return root


def test_reference_examples_equal_jax(record_dir):
    got = list(iterate_reference_examples(str(record_dir), get_config("tiny")))
    want = list(jax_iterate(str(record_dir), jax_config("tiny")))
    assert len(got) == len(want) == len(RECORDS)
    cfg = get_config("tiny")
    for (pos, n1, n2), a, b in zip(RECORDS, got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        assert a["stable"].shape == (cfg.height, cfg.width, 2 * (cfg.before_ch + 1))
        assert a["stable"].dtype == np.uint8 and a["unstable"].shape[-1] == 2
        assert a["mask1"].sum() == n1 and a["mask2"].sum() == n2


def test_convert_data_cli_equals_jax(record_dir, tmp_path, capsys):
    args = ["convert-data", "--records", str(record_dir), "--config", "tiny"]
    cli(args + ["--out", str(tmp_path / "port")])
    assert f"converted {len(RECORDS)} examples" in capsys.readouterr().out
    jax_cli(args + ["--out", str(tmp_path / "jax")])
    got, want = list_shards(str(tmp_path / "port")), list_shards(str(tmp_path / "jax"))
    assert len(got) == len(want) == 1
    a, b = read_shard(got[0]), read_shard(want[0])
    assert a.keys() == b.keys() and "flow" in a
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    cli(args + ["--out", str(tmp_path / "one"), "--limit", "1"])
    assert read_shard(list_shards(str(tmp_path / "one"))[0])["stable"].shape[0] == 1
