"""Victim-bucket naming for the window report.

Counterpart of `netobserv_tpu/query/core.py` (`victim_bucket_names`), kept
as a copy. Naming runs on the host with the numpy hash twin, so rendering a
report never launches device work.
"""

from __future__ import annotations

import numpy as np

from netobserv_tpu_torch.ops.hashing import DST_BUCKET_SEED, hash_words_np


def victim_bucket_names(heavy_words: np.ndarray, heavy: list[dict],
                        n_buckets: int) -> dict[int, list]:
    """Heavy-hitter addresses hashed into the EWMA victim buckets the
    anomaly signals use. Both directions name a victim: inbound traffic
    buckets via the dst words, outbound via the src words (the device folds
    both into one bucket family under DST_BUCKET_SEED).

    `heavy_words` are the (n, KEY_WORDS) key words of exactly the rows
    rendered into `heavy`, in the same order."""
    names: dict[int, list] = {}
    if not len(heavy):
        return names
    for cols, field in ((heavy_words[:, 4:8], "DstAddr"),
                        (heavy_words[:, 0:4], "SrcAddr")):
        buckets = hash_words_np(cols, seed=DST_BUCKET_SEED) & (n_buckets - 1)
        for j, b in enumerate(buckets):
            lst = names.setdefault(int(b), [])
            if len(lst) < 3 and heavy[j][field] not in lst:
                lst.append(heavy[j][field])
    return names
