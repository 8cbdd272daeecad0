"""Operation and byte counts of each configuration's work, one file per
configuration (`<config>.py`), worked out from its published shapes."""
