"""The serializer of a function shipped to another process: the agent
transport's payload and results, the Spark tasks and estimator
artifacts, the Ray actors' calls.

The rule of the JAX estimator's ``_by_value_pickler``
(``horovod_tpu/spark/estimator.py:35-41``): ``cloudpickle`` where it
imports, which serializes notebook and nested functions BY VALUE; the
stdlib ``pickle`` otherwise, which carries only module-level functions
(by reference). Without ``cloudpickle`` a closure raises at
:func:`dumps` with the reason; it is never dropped.
"""

from __future__ import annotations

import pickle


def by_value_pickler():
    """``cloudpickle`` when it imports, else ``pickle``."""
    try:
        import cloudpickle
        return cloudpickle
    except ImportError:
        return pickle


def dumps(obj) -> bytes:
    pickler = by_value_pickler()
    try:
        return pickler.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        if pickler is not pickle:
            raise
        raise pickle.PicklingError(
            f"cannot serialize {obj!r} without cloudpickle, which is not "
            f"installed: the stdlib pickle carries module-level functions "
            f"only, not closures or lambdas ({e})") from e


def loads(blob: bytes):
    """The inverse of :func:`dumps` (a ``cloudpickle`` blob needs
    ``cloudpickle`` importable where it is loaded)."""
    return pickle.loads(blob)
