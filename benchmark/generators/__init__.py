"""Traffic generators: each runs one kind of traffic, read from a mix's
parameter file (``benchmark/traffic/<mix>.json``, key ``generator``)."""
