"""Build hooks: compile the native experiment-log library at install time.

``native/explog.cpp`` exports a plain-C API consumed via ctypes
(cilqr_tpu/utils/explog.py) — this framework's replacement for the
reference's `rosbag record /experiment` persistence.  Building it as a
setuptools extension ships a ready .so inside wheels; source checkouts
fall back to `make -C native` on first use.

The module intentionally has no PyInit_ entry point: it is dlopen'ed with
ctypes, never imported.
"""

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class build_ext_no_pyinit(build_ext):
    """Skip the missing-PyInit export check (ctypes library, not a module)."""

    def get_export_symbols(self, ext):
        return []


setup(
    ext_modules=[
        Extension(
            "cilqr_tpu.utils._explog_native",
            sources=["native/explog.cpp"],
            extra_compile_args=["-O2", "-std=c++17"],
            language="c++",
        )
    ],
    cmdclass={"build_ext": build_ext_no_pyinit},
)
