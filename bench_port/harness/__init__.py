"""The parts of the harness that every cell shares."""
