"""One adapter module per agent family, named by the configuration's ``agent``."""
