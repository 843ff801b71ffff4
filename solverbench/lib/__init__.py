"""The harness: the spec and its files, the inputs, the timed loop, the
trace reduction and the roofline table."""
