"""The elastic driver and its parts (counterpart of
``horovod_tpu/runner/elastic/``; reference: ``horovod/runner/elastic/``)."""

from .discovery import (FixedHosts, HostDiscovery,  # noqa: F401
                        HostDiscoveryScript, HostManager)
from .driver import ElasticDriver, ElasticSettings, run_elastic  # noqa: F401
from .registration import WorkerStateRegistry  # noqa: F401
