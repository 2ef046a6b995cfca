"""Families, configuration files and a plain reference that the CPU tests
bring from here, to show that a model of another family enters the
harness by added files alone (``test_lcxbench_families.py``)."""
