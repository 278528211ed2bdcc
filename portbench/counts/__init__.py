"""Operation and byte counts of the measured work, from the configuration's shapes."""
