# Container parity with the reference deployment surface (reference: Dockerfile:1-18 —
# python-slim + dependency install), adapted to this stack: the C++ native layer needs a
# toolchain.  The base image runs JAX's CPU backend out of the box; for NVIDIA GPUs
# build from a CUDA base image and install JAX with its CUDA plugin (see below).

FROM python:3.11-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make curl \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app

COPY pyproject.toml README.md ./
COPY mlvectordb_tpu ./mlvectordb_tpu
COPY native ./native
COPY benchmarks ./benchmarks
COPY examples ./examples

RUN pip install --no-cache-dir . \
    && make -C native

# On an NVIDIA GPU host: pip install 'jax[cuda12]', then serve with --platform gpu
EXPOSE 8000

HEALTHCHECK --interval=30s --timeout=10s --start-period=60s \
    CMD curl -fsS http://localhost:8000/health || exit 1

CMD ["python", "-m", "mlvectordb_tpu.api.server", "--host", "0.0.0.0", "--port", "8000"]
