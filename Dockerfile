# nanocall_tpu containers (packaging parity with the reference's fat +
# slim Docker images; see SURVEY.md L7: Dockerfile, Dockerfile.slim.in,
# script/build-slim-docker-image).  For the GPU, build on a base image
# with JAX and its CUDA plugin (--build-arg BASE=<image with
# jax[cuda12]>); the default slim Python base runs on the CPU.
#
#   docker build -t nanocall-tpu .                 # fat (default: build stage)
#   docker build --target slim -t nanocall-tpu-slim \
#       --build-arg USER_ID=$(id -u) --build-arg GROUP_ID=$(id -g) \
#       --build-arg TZ=$(cat /etc/timezone) .      # slim runtime
#
# The reference's slim image ships the lddtree-extracted binary closure in
# a bare debian (script/build-slim-docker-image, script/get-lddtree); the
# Python-native equivalent is a multi-stage build whose runtime stage
# installs only the built wheel — no compiler toolchain, no build tree —
# with the same host-uid/tz/volume conventions (Dockerfile.slim.in).
ARG BASE=python:3.12-slim
FROM ${BASE} AS build

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/nanocall_tpu
COPY pyproject.toml README.md ./
COPY nanocall_tpu ./nanocall_tpu
COPY baseline ./baseline
COPY tools ./tools

# native host runtime + CPU baseline binary; the prebuilt .so rides inside
# the wheel so the slim stage needs no compiler.  MARCH=x86-64-v2: a
# DISTRIBUTED binary must not inherit the build host's ISA (-march=native
# would SIGILL on older CPUs); source installs still auto-build natively.
RUN make -C nanocall_tpu/native MARCH=x86-64-v2 \
    && g++ -O3 -std=c++17 -pthread \
         -o baseline/cpu_nanocall baseline/cpu_nanocall.cpp \
    && pip install --no-cache-dir build \
    && python -m build --wheel --outdir /dist \
    && pip install --no-cache-dir /dist/*.whl

ENTRYPOINT ["nanocall-tpu"]
CMD ["--version"]

# --- slim runtime image (reference Dockerfile.slim.in parity) -------------
FROM ${BASE} AS slim
ARG TZ=Etc/UTC
ARG USER_ID=1000
ARG GROUP_ID=1000
ARG USER_NAME=nanocall
ARG GROUP_NAME=nanocall

# use host timezone
ENV TZ=${TZ}
RUN ln -snf /usr/share/zoneinfo/${TZ} /etc/localtime \
    && echo ${TZ} > /etc/timezone

# use host id
RUN groupadd --gid ${GROUP_ID} ${GROUP_NAME} \
    && useradd --create-home --uid ${USER_ID} --gid ${GROUP_ID} ${USER_NAME}

COPY --from=build /dist/*.whl /tmp/
RUN pip install --no-cache-dir /tmp/*.whl && rm /tmp/*.whl

USER ${USER_NAME}
VOLUME ["/data"]
WORKDIR /data
ENTRYPOINT ["nanocall-tpu"]
CMD ["--version"]

# Last stage = default `docker build` target: the fat image, matching the
# header doc (multi-stage builds default to the FINAL stage, so without
# this alias a plain `docker build` would silently produce the slim image).
FROM build AS fat
