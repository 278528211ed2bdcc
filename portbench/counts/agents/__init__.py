"""One count module per agent family, named by the configuration's
``agent``; a module whose name starts with ``_`` holds what families share."""
