"""pytest plugins for every run from the repository's root."""
pytest_plugins = ("tests.time_limit",)
