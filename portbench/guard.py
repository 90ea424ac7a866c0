"""The import guard: no module of JAX, of its libraries or of the JAX
package may be loaded in a run's process. Names are compared by their
top-level part, whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("modules loaded that a run may not load: " + ", ".join(found))


def offenders(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
