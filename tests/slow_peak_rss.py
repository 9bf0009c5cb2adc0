"""Run each full-size parity test of the port (marked `slow`, outside
Tier-1) alone on the CPU, one process each, and print a JSON line with its
exit code, seconds and peak resident memory (the process's ru_maxrss):

    python tests/slow_peak_rss.py [node id ...]

With no node id it runs the four full-size tests.
"""
import json
import os
import subprocess
import sys
import time

TESTS = ("tests/test_torch_text.py::test_full_size_clip_text_model",
         "tests/test_torch_avsync.py::test_full_size_inputs",
         "tests/test_torch_evalnets.py::test_full_size_inputs",
         "tests/test_torch_unet.py::test_full_size_unet_parity")


def main(argv):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for test in argv or TESTS:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", test, "-m", "slow", "-n", "0",
             "-p", "no:randomly", "-p", "no:cacheprovider", "-q"],
            cwd=root, env=env)
        _, status, usage = os.wait4(proc.pid, 0)
        print(json.dumps({
            "test": test, "exit": os.waitstatus_to_exitcode(status),
            "seconds": round(time.perf_counter() - t0, 1),
            "peak_rss_gib": round(usage.ru_maxrss / 2 ** 20, 2)}),
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
