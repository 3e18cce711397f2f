"""Kinds of extra (per-record) columns, one module each, found by the
``kind`` of a configuration's extra column. Each defines
``make(spec: dict, rng, values_per_record) -> np.ndarray``; a configuration's
columns draw in their listed order from one generator seeded with
``seed + 1``."""
