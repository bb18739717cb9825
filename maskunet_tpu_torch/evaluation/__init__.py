"""See maskunet_tpu_torch/__init__.py."""
