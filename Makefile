.PHONY: test test-fast quality bench native clean ci precompile

# CI gate (the reference's rust.yml fmt/clippy/test analog): byte-compile
# lint, fast test tier, native build.  Run `make precompile` afterwards on
# the GPU host to populate the persistent compile cache (the PGO analog).
ci: native
	python -m py_compile $(shell find rustsasa_jax benches scripts -name '*.py') bench.py __graft_entry__.py
	python -m pytest tests/ -q -m "not slow"

precompile:
	python scripts/precompile_fused.py

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -m "not slow"

quality:
	python scripts/quality_report.py

bench:
	python bench.py

native:
	g++ -O3 -march=native -std=c++17 -shared -fPIC \
	    rustsasa_jax/native/fastparse.cpp \
	    -o rustsasa_jax/native/libfastparse.so -lz

clean:
	rm -rf rustsasa_jax/native/libfastparse.so .jax_cache \
	    $(shell find . -name __pycache__ -type d)
