"""Distributed runs over real sockets, one OS process per party — the
port's counterparts of the JAX package's examples/add_ids.py,
nonlocal_kernel.py and nonlocal_sha256.py, run with `python -m`, and
launch.py, which spawns a star of them (the role of
scripts/_launch_ranks.sh and nonlocal_sha256.sh)."""
