"""Temporary directories of the port's tests, removed when they are done.

pytest keeps the base temporary directories of its last three runs, and
the port's tests write checkpoints, converted towers, msgpack files and
maps of several hundred megabytes each: a run left some 9 GB behind for
the next to fill.  A test module imports ``remove_tmp_path`` (an autouse
fixture) to delete each test's ``tmp_path`` when the test ends; a
module-scoped directory from ``tmp_path_factory`` is removed by its own
fixture after its ``yield``.
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    """Delete the test's ``tmp_path`` (if it used one) after the test."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
