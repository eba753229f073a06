"""The reader's prefetch thread (`sixdof_tpu_torch/io/readers.py::
DataReader._prefetched`, the JAX reader's `_prefetched`): frame i is served
while frame i+1 decodes on a daemon thread.  Served frames are bit-equal to
direct decodes, the cache holds at most frames i and i+1, and a frame read
twice (a capture frame) decodes once."""
import collections
import os
import sys
import threading

import numpy as np
import torch

from sixdof_tpu_torch.io.readers import DataReader

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
JOIN_S = 60.0


def _counting(reader):
    """Wrap the reader's decoders; returns {kind: Counter of frame indices}."""
    counts = {"color": collections.Counter(), "depth": collections.Counter()}
    for kind in counts:
        load = getattr(reader, f"_load_{kind}")

        def counted(i, load=load, c=counts[kind]):
            c[i] += 1
            return load(i)

        setattr(reader, f"_load_{kind}", counted)
    return counts


def _settle(reader):
    """Wait for the decode threads in flight (bounded)."""
    for kind in ("color", "depth"):
        for t in list(reader._pf_inflight[kind].values()):
            t.join(JOIN_S)
            assert not t.is_alive()


def test_prefetched_frames_equal_direct_decodes_and_decode_once():
    reader = DataReader(SCENE)
    direct = DataReader(SCENE)
    counts = _counting(reader)
    n = len(reader)
    # the run loop's pattern: each frame once, capture frames (2, 4) twice
    order = [0, 1, 2, 2, 3, 4, 4, 5]
    for i in order:
        c, d = reader.get_color(i), reader.get_depth(i)
        assert c.dtype == np.uint8 and d.dtype == np.float64
        assert np.array_equal(c, direct._load_color(i))
        assert np.array_equal(d.view(np.uint64), direct._load_depth(i).view(np.uint64))
        for kind in ("color", "depth"):
            assert set(reader._pf_cache[kind]) <= {i, i + 1}, (kind, i)
            assert set(reader._pf_inflight[kind]) <= {i + 1}, (kind, i)
    _settle(reader)
    for kind in ("color", "depth"):
        assert counts[kind] == collections.Counter(range(n)), kind
        assert set(reader._pf_cache[kind]) <= {n - 1}


def test_prefetch_decodes_ahead_on_a_thread():
    reader = DataReader(SCENE)
    seen = []
    load = reader._load_color
    reader._load_color = lambda i: (seen.append((i, threading.current_thread().name)), load(i))[1]
    reader.get_color(0)
    _settle(reader)
    main = threading.current_thread().name
    assert seen[0] == (0, main) and seen[1][0] == 1 and seen[1][1] != main
    assert sorted(reader._pf_cache["color"]) == [0, 1]
    reader.get_color(1)  # served from the cache: no decode in this thread
    assert [i for i, t in seen if t == main] == [0]


def test_random_access_stays_bounded_and_correct():
    """Jumping back and forth: every frame equals its direct decode, and a
    decode-ahead for a frame the reader has moved past is dropped."""
    reader = DataReader(SCENE)
    direct = [DataReader(SCENE)._load_color(i) for i in range(len(reader))]
    for i in [3, 0, 5, 1, 1, 4, 2, 0]:
        assert np.array_equal(reader.get_color(i), direct[i])
        assert set(reader._pf_cache["color"]) <= {i, i + 1}
    _settle(reader)
    assert set(reader._pf_cache["color"]) <= {0, 1}


def test_concurrent_readers_stress():
    """More reader threads than cores, a short switch interval: every served
    frame equals its direct decode and the cache ends bounded."""
    reader = DataReader(SCENE)
    direct = [DataReader(SCENE)._load_color(i) for i in range(len(reader))]
    errors = []

    def work(seed):
        rng = np.random.RandomState(seed)
        for i in rng.randint(0, len(direct), 12):
            if not np.array_equal(reader.get_color(int(i)), direct[i]):
                errors.append(int(i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    _settle(reader)
    assert errors == []
    assert len(reader._pf_cache["color"]) <= 2
