"""JAX scanner state to port state.

``snapshot_from_jax`` gives the port the JAX scanner's own device tables,
so that both packages scan with bit-identical tables; the port's own
``DeviceSnapshot`` must build the same arrays from the same
``DenseTables`` (tests/test_torch_scanner.py checks both). Only the tests
call it: it needs the JAX scanner, and so JAX.
"""

from __future__ import annotations

import numpy as np

from ..models.snapshot import DeviceSnapshot


def snapshot_from_jax(jax_scanner, device="cuda") -> DeviceSnapshot:
    """The port's snapshot of a JAX ``DenseScanner``'s tables: capacity-
    padded ``dflat`` and ``nb_out`` and the k-gram tables (packed, or the
    two-table ``delta_k`` and ``cnt_k``), with k and the count bits. A
    scanner built on it with the JAX scanner's ``halo`` has the same
    ``halo_steps``."""
    st = jax_scanner._stepped
    tabs = [np.asarray(t) for t in jax_scanner._st_dev]
    packed = tabs[0] if st is not None and st.packed is not None else None
    delta_k, cnt_k = (tabs if st is not None and st.packed is None
                      else (None, None))
    return DeviceSnapshot.from_arrays(
        jax_scanner.tables, np.asarray(jax_scanner._dflat),
        np.asarray(jax_scanner._nb_out), packed, jax_scanner.step_k,
        0 if st is None else st.count_bits, device, delta_k=delta_k,
        cnt_k=cnt_k)
