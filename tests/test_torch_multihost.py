"""The port's multi-host runtime (``runtime/multihost.py``) against the
JAX package's.

- One process (one host): ``num_hosts``, ``host_index``,
  ``is_primary_host`` and ``local_device_slice`` equal the JAX
  package's over the same one device; ``init_hybrid_mesh`` gives the
  same shape and axis names (DCN axes outermost), and its size mismatch
  the same ``ValueError`` text; ``process_allgather`` adds a leading
  axis and ``broadcast_from_primary`` returns its input, as JAX's do;
  ``initialize()`` without arguments is a no-op, and a partial call is
  refused.
- One 2-rank gloo launch as two one-device hosts: ``initialize`` at a
  ``tcp://`` coordinator (twice: idempotent), 2 hosts, a ``dcn`` 2 x
  ``ici`` 1 mesh with each rank on its own coordinate, JAX's
  slice-count ``ValueError`` for an ICI axis that would span hosts,
  ``process_allgather`` and ``broadcast_from_primary`` equal on both
  ranks.

Serial run time ~10 s.
"""

import json

import jax
import numpy as np
import pytest

import _torch_fault_workers as fw
from _torch_port import launch_cpu_ranks
from distributed_pytorch_tpu.runtime import multihost as jmultihost
from distributed_pytorch_tpu_torch.runtime import multihost


def test_one_host_equals_jax():
    one = jax.devices()[:1]
    assert multihost.num_hosts() == jmultihost.num_hosts() == 1
    assert multihost.host_index() == jmultihost.host_index() == 0
    assert multihost.is_primary_host() and jmultihost.is_primary_host()
    start, stop = jmultihost.local_device_slice()
    assert multihost.local_device_slice() == (0, 1)
    assert (start, stop) == (0, len(jax.local_devices()))
    for ici, dcn in (([("dp", 1)], []), ([("dp", 1), ("tp", 1)],
                                         [("dcn", 1)])):
        got = multihost.init_hybrid_mesh(ici, dcn)
        want = jmultihost.init_hybrid_mesh(ici, dcn, devices=one)
        assert tuple(got.mesh.shape) == want.devices.shape
        assert tuple(got.mesh_dim_names) == want.axis_names
    for ici, dcn in (([("dp", 2)], []), ([("tp", 1)], [("dcn", 3)])):
        with pytest.raises(ValueError) as a:
            multihost.init_hybrid_mesh(ici, dcn)
        with pytest.raises(ValueError) as b:
            jmultihost.init_hybrid_mesh(ici, dcn, devices=one)
        assert str(a.value) == str(b.value)
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(multihost.process_allgather(x),
                                  jmultihost.process_allgather(x))
    np.testing.assert_array_equal(multihost.broadcast_from_primary(x),
                                  jmultihost.broadcast_from_primary(x))
    multihost.initialize()
    assert not multihost._initialized
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)


def test_two_hosts_over_gloo(tmp_path):
    launch_cpu_ranks(fw.multihost_worker, 2, str(tmp_path), timeout_s=60)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in (0, 1)]
    for r, rec in enumerate(recs):
        assert rec["num_hosts"] == 2 and rec["host_index"] == r
        assert rec["is_primary_host"] == (r == 0)
        assert rec["slice"] == [r, r + 1]
        assert (rec["mesh_shape"], rec["mesh_names"]) == ([2, 1],
                                                          ["dp", "tp"])
        assert rec["mesh_ranks"] == [[0], [1]]
        assert rec["my_coordinate"] == [r, 0]
        assert rec["wrong_slices"] == (
            "dcn axes multiply to 1 but the devices span 2 slices — the DCN "
            "dimension must equal the slice count so ici axes stay within "
            "one ICI domain")
        assert rec["gathered"] == [[0, 0], [1, 10]]
        assert rec["bcast"] == [7, 7, 7]
