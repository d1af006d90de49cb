"""The port's TensorFlow-free data path against the reference's.

- ``crc32c`` (numpy, chunked) equals the byte loop and the standard check
  value; a framed record carries TFRecord's masked CRCs.
- The port's fixture file (``write_synthetic_tfrecords``: the same numpy
  draws, a hand-encoded ``tf.train.Example``) decodes, through the
  reference's native reader and through ``tf.data``, into the examples
  of the reference's writer (which uses TensorFlow). The protobuf bytes
  need not match; the decoded fields do, to the byte.
- The port's ``read_examples`` and ``make_native_iterator`` give the
  reference's examples and batches to the byte, for several seeds, shard
  splits, skips, filters and remainders.
- The reader's library is built under the build directory, never beside
  its source.
"""

import struct

import numpy as np
import pytest

from gansynth_tpu.data import native_tfrecord as j_native
from gansynth_tpu.data.fixtures import \
    write_synthetic_tfrecords as j_write_fixtures
from gansynth_tpu.data.nsynth import make_nsynth_example_iterator
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.data import fixtures
from gansynth_tpu_torch.data import native_tfrecord as t_native
from gansynth_tpu_torch.kernels._build import build_dir
from gansynth_tpu_torch.utils.config import Config

pytest.importorskip("tensorflow")   # the reference's writer and tf.data

N = 24
PITCHES = range(20, 90, 3)   # some outside 24..84, for the pitch filter
FIELDS = ("pitch", "velocity", "instrument_family", "instrument_source")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfrecord")
    port = fixtures.write_synthetic_tfrecords(
        str(d / "port.tfrecord"), num_examples=N, pitches=PITCHES, seed=5)
    ref = j_write_fixtures(str(d / "ref.tfrecord"), num_examples=N,
                           pitches=PITCHES, seed=5)
    return port, ref


def _assert_same_examples(got, want):
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.audio, w.audio)
        assert g.audio.dtype == w.audio.dtype == np.float32
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), f
        np.testing.assert_array_equal(g.qualities, w.qualities)


@pytest.mark.parametrize("n", [0, 1, 9, 2047, 2048, 2049, 70001])
def test_crc32c_matches_the_byte_loop(n):
    table, _ = fixtures._crc_tables()
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    assert fixtures.crc32c(data) == crc ^ 0xFFFFFFFF
    assert fixtures.crc32c(b"123456789") == 0xE3069283   # the check value


def test_frame_layout():
    framed = fixtures.tfrecord_frame(b"abc")
    length, crc_len = struct.unpack("<QI", framed[:12])
    assert length == 3 and framed[12:15] == b"abc"
    assert crc_len == fixtures.masked_crc32c(framed[:8])
    assert struct.unpack("<I", framed[15:])[0] == \
        fixtures.masked_crc32c(b"abc")


def test_port_fixtures_decode_to_the_reference_writers_examples(files):
    port, ref = files
    want = list(j_native.read_examples(ref))
    _assert_same_examples(list(j_native.read_examples(port)), want)
    # non-degenerate metadata, so the equality is not vacuous
    assert len({w.velocity for w in want}) > 1
    assert len({w.instrument_family for w in want}) > 1
    assert any(w.qualities.any() for w in want)
    assert all(w.qualities.shape == (10,) for w in want)


def test_port_fixtures_decode_through_tf_data(files):
    port, ref = files
    cfg = JConfig()
    got = list(make_nsynth_example_iterator([port], cfg))
    want = list(make_nsynth_example_iterator([ref], cfg))
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_port_reader_equals_the_reference_reader(files):
    port, _ = files
    _assert_same_examples(list(t_native.read_examples(port)),
                          list(j_native.read_examples(port)))


@pytest.mark.parametrize("kwargs", [
    dict(seed=0),
    dict(seed=7, shuffle_buffer=5),
    dict(seed=3, num_shards=3, shard_index=1),
    dict(seed=3, num_shards=2, shard_index=0, skip_batches=2),
    dict(seed=1, skip_batches=5, acoustic_only=False),
    dict(families=[0, 3, 7], shuffle=False, repeat=False,
         drop_remainder=False),
    dict(shuffle=False, repeat=False, drop_remainder=False, batch_size=5),
])
def test_native_iterator_batches_equal_the_references(files, kwargs):
    port, _ = files
    kwargs = {"batch_size": 4, "shuffle_buffer": 8, **kwargs}
    want_it = j_native.make_native_iterator([port], JConfig(), **kwargs)
    got_it = t_native.make_native_iterator([port], Config(), **kwargs)
    for i in range(8):
        want = next(want_it, None)
        got = next(got_it, None)
        if want is None:
            assert got is None
            break
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, i
            assert g.tobytes() == w.tobytes(), i


def test_library_is_built_under_the_build_dir():
    path = t_native.library_path()
    assert path.is_relative_to(build_dir().parent)
    assert not path.is_relative_to(t_native._SRC.parent)
    t_native._load_library()
    assert path.is_file()
