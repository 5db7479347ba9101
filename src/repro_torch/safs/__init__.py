"""repro_torch.safs — the file-backed SAFS page store (paper §3.4.1–§3.4.4),
port of `repro.safs`, with checkpoint-sourced page repair."""
from repro_torch.safs.pagefile import (PAGE_SIZE, CrashPoint, PageFile,
                                       coalesce_runs, flip_bit, page_crc)
from repro_torch.safs.cache import PageCache, WriteBehind, WriteBehindError
from repro_torch.safs.prefetch import PrefetchError, Prefetcher
from repro_torch.safs.faults import (DEFAULT_RETRY, CorruptPageError,
                                     FaultPlan, FaultRule, IntegrityCounters,
                                     RetryPolicy, SafsIOError,
                                     TransientIOError, is_transient,
                                     with_retries)
from repro_torch.safs.backend import (RamBackend, SafsBackend,
                                      StorageBackend, make_backend)
from repro_torch.safs.scrub import (Scrubber, newest_verified_step,
                                    repair_from_checkpoint)

__all__ = [
    "PAGE_SIZE", "CrashPoint", "PageFile", "coalesce_runs",
    "flip_bit", "page_crc",
    "PageCache", "WriteBehind", "WriteBehindError",
    "PrefetchError", "Prefetcher",
    "DEFAULT_RETRY", "CorruptPageError", "FaultPlan", "FaultRule",
    "IntegrityCounters", "RetryPolicy",
    "SafsIOError", "TransientIOError", "is_transient", "with_retries",
    "RamBackend", "SafsBackend", "StorageBackend", "make_backend",
    "Scrubber", "newest_verified_step", "repair_from_checkpoint",
]
