/* C ABI of the port's shim (tpkt_shim.c), the same ABI as the
 * reference's c/shim/tpu_shim.h, so c/common/tpu_client.c loads either.
 *
 * The benchmark driver hands raw host buffers across this boundary;
 * the shim (which embeds CPython) passes them to
 * tpukernels_torch.capi.run_from_c, which wraps them as tensors,
 * dispatches the named kernel through the port's registry to its CUDA
 * kernel, and copies results back into the driver's buffers before
 * returning — so the driver's wall-clock timing of tpu_run() includes
 * H2D, compute and D2H.
 */
#ifndef TPKT_SHIM_H
#define TPKT_SHIM_H

#ifdef __cplusplus
extern "C" {
#endif

/* Initialize the embedded interpreter and import the port's C entry.
 * Idempotent. Returns 0 on success. */
int tpu_init(void);

/* Run kernel `name`. `params_json` describes buffer shapes/dtypes/roles
 * and scalar parameters; `bufs` are the raw host pointers in the same
 * order as the JSON "buffers" list. Returns 0 on success. */
int tpu_run(const char *name, const char *params_json, void **bufs,
            int nbufs);

/* Flush the Python side's teardown state (idempotent; the interpreter
 * stays up and later calls still work). Also runs when the host exits. */
void tpu_shutdown(void);

#ifdef __cplusplus
}
#endif
#endif /* TPKT_SHIM_H */
