"""Twin catalogs and sessions: one SphinxQL stream through both packages.

A ``TwinCatalog`` holds a JAX ``Catalog`` and the port's
``Catalog(device="cpu")``; a ``TwinSession`` over it sends every
statement to a session of each, seeds ``random`` the same way before
each side (ORDER BY RAND() shuffles with the global ``random``), holds
the two lists of ``QLResult`` equal (columns, rows, error, warning,
affected) and hands back the JAX package's, so that a test written for
the JAX package runs its own assertions on top.

Only time-dependent fields are masked, each by name:
- SHOW META: the ``time`` row;
- SHOW STATUS: the ``uptime`` row;
- SHOW THREADS: the ``Connected``, ``Work time`` and ``Last job took``
  columns;
- SHOW PROFILE: the ``Duration`` column.

A catalog with a ``data_dir`` gives the port the sibling directory
``<data_dir>.port``, so that both packages write and reopen their own
files.
"""
from __future__ import annotations

import random

from manticoresearch_tpu.exec import session as jax_session
from manticoresearch_tpu_torch.exec import session as port_session

_MASK_ROWS = {("Variable_name", "Value"): "time",     # SHOW META
              ("Counter", "Value"): "uptime"}         # SHOW STATUS
_MASK_COLS = ("Connected", "Work time", "Last job took",  # SHOW THREADS
              "Duration")                                  # SHOW PROFILE
MASK = "<masked: time>"
_seed = [0]


def port_dir(data_dir):
    return None if data_dir is None else str(data_dir).rstrip("/") + ".port"


def masked(r) -> tuple:
    """A QLResult as a comparable tuple, its time fields masked."""
    cols = list(r.columns)
    rows = [tuple(row) for row in r.rows]
    key = _MASK_ROWS.get(tuple(cols))
    if key is not None:
        rows = [(row[0], MASK) + row[2:] if row and row[0] == key else row
                for row in rows]
    idx = [i for i, c in enumerate(cols) if c in _MASK_COLS]
    if idx:
        rows = [tuple(MASK if i in idx else v for i, v in enumerate(row))
                for row in rows]
    return (cols, rows, r.error, r.warning, r.affected)


def assert_same(jax_rs, port_rs, what=""):
    assert len(jax_rs) == len(port_rs), (what, jax_rs, port_rs)
    for j, p in zip(jax_rs, port_rs):
        mj, mp = masked(j), masked(p)
        assert mj == mp, (what, mj, mp)
        # an internal error (a crashed statement) never passes as equal
        assert not (j.error or "").startswith("internal error"), (what, j)


class TwinCatalog:
    def __init__(self, data_dir=None):
        self.jax = jax_session.Catalog(data_dir)
        self.port = port_session.Catalog(port_dir(data_dir), device="cpu")

    def __getattr__(self, name):
        return getattr(self.jax, name)


class TwinSession:
    def __init__(self, catalog=None):
        catalog = catalog if catalog is not None else TwinCatalog()
        self.twin_catalog = catalog
        self.jax = jax_session.Session(catalog.jax)
        self.port = port_session.Session(catalog.port)

    @property
    def catalog(self):
        return self.twin_catalog.jax

    def __getattr__(self, name):
        return getattr(self.jax, name)

    def execute(self, sql: str):
        _seed[0] += 1
        random.seed(_seed[0])
        jax_rs = self.jax.execute(sql)
        random.seed(_seed[0])
        port_rs = self.port.execute(sql)
        assert_same(jax_rs, port_rs, sql)
        for flag in ("autocommit", "in_txn", "last_plan"):
            assert getattr(self.jax, flag) == getattr(self.port, flag), flag
        return jax_rs

    def close(self):
        self.jax.close()
        self.port.close()

