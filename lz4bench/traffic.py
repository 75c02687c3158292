"""The one generator of requests, read from a traffic mix's file of parameters.

A mix (``traffic/<name>.json``) names the pieces it is made of, each a
file found by name (``catalog.py``), and their parameters beside them:

* ``"objects"``: how the configuration's corpus becomes the objects.
  ``members``: each member whole.  ``cuts``: ``count`` pieces cut from the
  members, their sizes log-uniform in ``sizes`` = ``[lo, hi]`` bytes.
* ``"order"``: one pass over the inputs, repeated until the window
  closes.  ``permutation``: one permutation drawn from the seed.
* ``"op"``: the calls (``ops/<op>.py``): ``prepare`` makes the inputs
  from the objects (a frame an object for reads), ``call`` is one
  request, ``check`` holds the answers to the reference.
* ``"control"``: the program's arguments that break the configuration's
  guarantee (``run.py --control``); the benchmark's runs never pass them.

Every seed gets the same work in another order: the sizes of the objects
do not depend on the seed, only their bytes and their order do.  A new
mix of these kinds is a data file alone.
"""

from __future__ import annotations

import hashlib

import numpy as np


def rng(seed: int | None, *salt: str) -> np.random.Generator:
    """A generator keyed by the run's seed (any whole number) and a salt;
    ``seed=None`` for what has to be the same under every seed."""
    h = hashlib.sha256(":".join(map(str, ("lz4bench", seed, *salt))).encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))
