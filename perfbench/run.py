"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output, and each compared number beside its limit as the last
lines of standard error. Needs the CUDA devices the cell asks for."""
import os
import sys

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # build and kernel caches at fixed paths inside the checkout (the
    # program's own nvcc build directory is src/repro_torch/_build)
    cache = os.path.join(root, "perfbench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path[:0] = [root, os.path.join(root, "src")]
    from perfbench.harness import main
    sys.exit(main())
