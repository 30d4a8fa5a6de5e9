"""The entry points a traffic mix can drive, one file each: the mix's
``entry`` names the file, whose class ``Entry`` the harness builds (see
``benchmark/common.py`` for what an entry has)."""
