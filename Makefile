TESTENV = JAX_PLATFORMS=cpu JAX_ENABLE_X64=1

.PHONY: test bench smoke golden native clean

test:
	$(TESTENV) python -m pytest tests/ -x -q

bench:
	python bench.py

# on a machine with one NVIDIA GPU; exits non-zero anywhere else
smoke:
	python chip_smoke.py

golden:
	$(TESTENV) python tests/make_golden.py

native:
	$(MAKE) -C native

clean:
	rm -rf bfqzip_tpu/**/__pycache__ tests/__pycache__ .pytest_cache
