# Top-level convenience targets (the reference's Makefile builds its 8 C++
# binaries; here the crypto is JAX — only the native runtime needs a build).

.PHONY: all native test test-core bench sizes clean

all: native

native:                       # C++ artifact server + serde (runtime/)
	$(MAKE) -C ppqsflhe/runtime all

test:                         # full suite (CPU, virtual 8-device mesh)
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

test-core:                    # <3 min core lane
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow"

bench:                        # headline GPU bench (one JSON line)
	python bench.py

sizes:                        # wire/artifact size table (CPU)
	JAX_PLATFORMS=cpu python bench_sizes.py

clean:
	rm -rf ppqsflhe/runtime/bin ppqsflhe/runtime/lib
