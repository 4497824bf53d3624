"""The port's benchmark: the terminal tick a player feels.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, on the card, from the root of a
checkout, and prints one JSON result line. See ``benchmark/README.md``.
"""
