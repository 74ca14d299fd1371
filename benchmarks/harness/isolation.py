"""The modules a run may not load: JAX and the JAX package.

Compared by the top-level name of each module, the part before the first
dot, as a whole word: the port's `stabnet_tpu_torch` begins with the JAX
package's `stabnet_tpu`, and is allowed.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "stabnet_tpu")


def forbidden_modules(names: Iterable[str] = None,
                      forbidden=FORBIDDEN) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".", 1)[0] for n in names} & set(forbidden))
