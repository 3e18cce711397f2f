"""Generators of the configurations' data, one module each, found by the
``generator`` name in a configuration file. Each defines
``generate(sizes: dict, seed: int) -> Ragged``."""
