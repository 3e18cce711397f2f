"""Plain NumPy reference of the benchmark's read path.

It works out from the generated columns alone what every bbox read of a
written file must return: the writer's file order (Hilbert sort of record
bbox centres within each row group), the record-aligned pages and their
bounds (the light-weight index), the records that survive the refine, their
coordinates in file order with their Dremel levels, and their extra
columns. It imports numpy and the standard library only: nothing of the
port, of ``jax`` or of the JAX package.
"""
