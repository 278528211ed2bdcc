"""One adapter module per agent family, named by the configuration's
``agent``: its ``Adapter`` and ``NUMBERS``, the numbers it compares."""
