/* The port's C shim: embeds CPython and forwards the C drivers' kernel
 * calls to tpukernels_torch.capi.run_from_c.
 *
 * It exports the ABI that c/common/tpu_client.c resolves (tpu_init,
 * tpu_run, tpu_shutdown; see tpkt_shim.h), so the unchanged C drivers
 * reach the port when TPU_KERNELS_SHIM names the library that
 * tpukernels_torch/_build.py builds from this file
 * (_build/libtpkt_shim-<hash>.so). It is the reference's
 * c/shim/tpu_shim.c with the port's module and knobs: TPKT_SHIM_ROOT,
 * TPKT_SHIM_SITE (os.pathsep-separated), TPKT_SHIM_VERBOSE and
 * TPKT_FLUSH_TIMEOUT.
 */
#ifndef _GNU_SOURCE
#define _GNU_SOURCE /* on_exit (glibc): exit status for the watchdog */
#endif

#include "tpkt_shim.h"

#include <Python.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* baked in by _build.build_shim: the repository root and the
 * site-packages of the interpreter that built the shim */
#ifndef TPKT_DEFAULT_ROOT
#define TPKT_DEFAULT_ROOT "."
#endif
#ifndef TPKT_SITE_PACKAGES
#define TPKT_SITE_PACKAGES ""
#endif

#define CAPI_MODULE "tpukernels_torch.capi"

static PyObject *g_run_from_c = NULL; /* CAPI_MODULE.run_from_c */
static int g_initialized = 0;

static void shutdown_on_exit(int status, void *arg);

static int verbose(void) {
    const char *v = getenv("TPKT_SHIM_VERBOSE");
    return v && v[0] && strcmp(v, "0") != 0;
}

int tpu_init(void) {
    if (g_initialized) return 0;

    if (!Py_IsInitialized()) {
        PyConfig config;
        PyConfig_InitPythonConfig(&config);
        /* Leave stdout/stderr and signal handling to the C host. */
        config.install_signal_handlers = 0;
        PyStatus status = Py_InitializeFromConfig(&config);
        PyConfig_Clear(&config);
        if (PyStatus_Exception(status)) {
            fprintf(stderr, "tpkt_shim: Py_InitializeFromConfig failed\n");
            return 1;
        }
    }

    /* A Python host reaching here via ctypes does NOT hold the GIL
     * (ctypes releases it around foreign calls) — every C-API touch
     * below needs it. Recursion-safe for the C host, whose main
     * thread still holds the GIL from Py_InitializeFromConfig. */
    PyGILState_STATE gil = PyGILState_Ensure();

    /* Make the port and the building interpreter's site-packages
     * importable (the root first). Overridable at runtime; defaults
     * baked in by _build.build_shim. */
    const char *root = getenv("TPKT_SHIM_ROOT");
    if (!root || !root[0]) root = TPKT_DEFAULT_ROOT;
    const char *site = getenv("TPKT_SHIM_SITE");
    if (!site || !site[0]) site = TPKT_SITE_PACKAGES;

    char buf[8192];
    int len = snprintf(buf, sizeof(buf),
                       "import os, sys\n"
                       "for _p in r'%s'.split(os.pathsep)[::-1] + [r'%s']:\n"
                       "    if _p and _p not in sys.path:\n"
                       "        sys.path.insert(0, _p)\n",
                       site, root);
    int rc = 1;
    if (len < 0 || (size_t)len >= sizeof(buf)) {
        fprintf(stderr, "tpkt_shim: TPKT_SHIM_ROOT/TPKT_SHIM_SITE too long\n");
        goto out;
    }
    if (PyRun_SimpleString(buf) != 0) {
        fprintf(stderr, "tpkt_shim: failed to extend sys.path\n");
        goto out;
    }

    PyObject *mod = PyImport_ImportModule(CAPI_MODULE);
    if (!mod) {
        PyErr_Print();
        fprintf(stderr, "tpkt_shim: cannot import " CAPI_MODULE
                        " (TPKT_SHIM_ROOT=%s)\n",
                root);
        goto out;
    }
    g_run_from_c = PyObject_GetAttrString(mod, "run_from_c");
    Py_DECREF(mod);
    if (!g_run_from_c || !PyCallable_Check(g_run_from_c)) {
        PyErr_Print();
        fprintf(stderr, "tpkt_shim: " CAPI_MODULE ".run_from_c missing\n");
        goto out;
    }
    rc = 0;
out:
    PyGILState_Release(gil);
    if (rc != 0) return rc;
    g_initialized = 1;
    /* Flush-on-exit for every C host, including ones that dlopen the
     * ABI directly and never call tpu_shutdown themselves. on_exit
     * (not atexit) so the handler sees the host's exit status: the
     * wedged-flush watchdog must _exit with the REAL status — a
     * benchmark that exit(1)ed on a failed check must not be turned
     * into rc=0 (nor a pass into a failure) by the flush bailout. */
    on_exit(shutdown_on_exit, NULL);
    if (verbose()) fprintf(stderr, "tpkt_shim: initialized (root=%s)\n", root);
    return 0;
}

int tpu_run(const char *name, const char *params_json, void **bufs,
            int nbufs) {
    if (!g_initialized && tpu_init() != 0) return 1;

    /* See tpu_init: a ctypes host calls in without the GIL. */
    PyGILState_STATE gil = PyGILState_Ensure();
    long rc = 1;
    PyObject *addrs = PyList_New(nbufs);
    if (!addrs) goto out;
    for (int i = 0; i < nbufs; i++) {
        PyList_SET_ITEM(addrs, i,
                        PyLong_FromUnsignedLongLong((unsigned long long)(uintptr_t)bufs[i]));
    }
    PyObject *res =
        PyObject_CallFunction(g_run_from_c, "ssO", name, params_json, addrs);
    Py_DECREF(addrs);
    if (!res) {
        PyErr_Print();
        fprintf(stderr, "tpkt_shim: kernel '%s' raised\n", name);
        goto out;
    }
    rc = PyLong_AsLong(res);
    Py_DECREF(res);
    if (rc == -1 && PyErr_Occurred()) {
        PyErr_Print();
        rc = 1;
    }
out:
    PyGILState_Release(gil);
    return (int)rc;
}

/* Flush Python-side teardown state (the metrics snapshot). Caller
 * must hold the GIL. */
static void flush_python_side(void) {
    PyObject *mod = PyImport_ImportModule(CAPI_MODULE);
    if (mod) {
        PyObject *res = PyObject_CallMethod(mod, "shutdown_from_c", NULL);
        if (!res) PyErr_Print();
        Py_XDECREF(res);
        Py_DECREF(mod);
    } else {
        PyErr_Print();
    }
}

static struct {
    pthread_mutex_t mu;
    pthread_cond_t cv;
    unsigned gen;  /* bumps per tpu_shutdown attempt: a worker from a
                    * PRIOR (timed-out, detached) attempt that finally
                    * unparks must neither flush during teardown nor
                    * satisfy the current attempt's wait */
    int done;
    int flushing;  /* worker holds the GIL and is running the flush */
    int abandoned; /* timed out: process teardown is underway */
} g_flush = {PTHREAD_MUTEX_INITIALIZER, PTHREAD_COND_INITIALIZER, 0, 0, 0, 0};

/* Exit status the watchdog re-raises when it has to _exit: the real
 * one when we're inside exit() (recorded by shutdown_on_exit), else a
 * distinctive code for an explicit mid-program tpu_shutdown whose
 * flush wedged (the host intended to continue; 86 marks the kill). */
static int g_exit_status = 86;

static void shutdown_on_exit(int status, void *arg) {
    (void)arg;
    g_exit_status = status;
    tpu_shutdown();
}

/* The GIL timeout below bounds *acquiring* the GIL, but the flush
 * itself (a journal write to a stuck file system) can block forever —
 * on the inline path there is no other bound at all. A detached
 * watchdog forces the exit if a flush attempt is still unfinished after
 * the deadline: by then the host's results are printed and a lost
 * metrics snapshot beats a hung process.
 * TPKT_FLUSH_TIMEOUT (seconds, default 30) tunes it — primarily so the
 * wedge path is testable without a 30 s wait. */
static int flush_timeout_s(void) {
    const char *v = getenv("TPKT_FLUSH_TIMEOUT");
    if (v && v[0]) {
        int t = atoi(v);
        if (t > 0) return t;
    }
    return 30;
}
static struct {
    pthread_mutex_t mu;
    pthread_cond_t cv;
    unsigned armed_gen; /* bumped when a flush attempt starts */
    unsigned done_gen;  /* advanced to armed_gen when it finishes */
} g_wd = {PTHREAD_MUTEX_INITIALIZER, PTHREAD_COND_INITIALIZER, 0, 0};

static void *flush_watchdog(void *arg) {
    unsigned my_gen = (unsigned)(uintptr_t)arg;
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    /* Strictly later than the worker path's GIL bound (min(t,10)):
     * the clean abandon-flush-and-keep-running outcome must win the
     * race against this _exit, so give it a 5 s head start. */
    ts.tv_sec += flush_timeout_s() + 5;
    pthread_mutex_lock(&g_wd.mu);
    int rc = 0;
    while ((int)(g_wd.done_gen - my_gen) < 0 && rc == 0)
        rc = pthread_cond_timedwait(&g_wd.cv, &g_wd.mu, &ts);
    int done = (int)(g_wd.done_gen - my_gen) >= 0;
    pthread_mutex_unlock(&g_wd.mu);
    if (!done) {
        fprintf(stderr, "tpkt_shim: shutdown flush wedged for %ds; "
                        "forcing exit\n",
                flush_timeout_s() + 5);
        fflush(NULL); /* don't lose the host's buffered results */
        _exit(g_exit_status);
    }
    return NULL;
}

static void *flush_worker(void *arg) {
    unsigned my_gen = (unsigned)(uintptr_t)arg;
    PyGILState_STATE gil = PyGILState_Ensure();
    /* If the main thread gave up waiting (or a later tpu_shutdown
     * call superseded this attempt), exit() may already be running
     * atexit handlers/static destructors — touching Python or CUDA now
     * could segfault a process whose results were already printed.
     * Checked AFTER acquiring the GIL so the common race (GIL freed
     * just past the timeout) skips the flush rather than crashing.
     * Setting `flushing` under the same lock makes the states
     * mutually exclusive: either the timeout abandons a worker still
     * parked on the GIL, or the main thread sees `flushing` and
     * waits for the (brief) flush to finish — never both. */
    pthread_mutex_lock(&g_flush.mu);
    int stale = g_flush.gen != my_gen || g_flush.abandoned;
    if (!stale) g_flush.flushing = 1;
    pthread_mutex_unlock(&g_flush.mu);
    if (!stale) flush_python_side();
    PyGILState_Release(gil);
    pthread_mutex_lock(&g_flush.mu);
    if (g_flush.gen == my_gen) {
        g_flush.done = 1;
        pthread_cond_signal(&g_flush.cv);
    }
    pthread_mutex_unlock(&g_flush.mu);
    return NULL;
}

void tpu_shutdown(void) {
    /* Intentionally do NOT Py_FinalizeEx: CUDA runtime and PyTorch
     * threads may still be alive and finalization ordering with them
     * is undefined. The OS reclaims memory at exit — but state that
     * only flushes on clean teardown (the metrics snapshot) is flushed
     * through a Python-side hook, since a never-finalized interpreter
     * never runs Python atexit handlers. */
    /* A Python host (ctypes/dlopen into a normal interpreter) will
     * have finalized the runtime before C atexit handlers run —
     * touching the C-API then aborts the process.
     * No run-once latch: a host that calls tpu_shutdown explicitly and
     * then keeps dispatching records more — the atexit flush must
     * still run for it. */
    if (g_initialized && Py_IsInitialized()) {
        pthread_t wd;
        pthread_mutex_lock(&g_wd.mu);
        unsigned wd_gen = ++g_wd.armed_gen;
        pthread_mutex_unlock(&g_wd.mu);
        if (pthread_create(&wd, NULL, flush_watchdog,
                           (void *)(uintptr_t)wd_gen) == 0)
            pthread_detach(wd);
        if (PyGILState_Check()) {
            /* Common C-host case: the main thread initialized Python,
             * still holds the GIL, and runs atexit — flush inline. */
            flush_python_side();
        } else {
            /* PyGILState_Ensure has no timeout, and a PyTorch
             * background thread holding the GIL at exit would park
             * this exit handler forever. Bound the wait: acquire the
             * GIL on a helper thread and abandon the flush (losing at
             * worst the metrics snapshot) if it can't get the
             * GIL in time — the process must exit. */
            pthread_t t;
            pthread_mutex_lock(&g_flush.mu);
            unsigned my_gen = ++g_flush.gen;
            g_flush.done = 0;
            g_flush.flushing = 0;
            g_flush.abandoned = 0;
            pthread_mutex_unlock(&g_flush.mu);
            if (pthread_create(&t, NULL, flush_worker,
                               (void *)(uintptr_t)my_gen) != 0) {
                fprintf(stderr,
                        "tpkt_shim: cannot spawn shutdown flush thread; "
                        "exiting without flush\n");
            } else {
                struct timespec ts;
                clock_gettime(CLOCK_REALTIME, &ts);
                int gil_t = flush_timeout_s();
                ts.tv_sec += gil_t < 10 ? gil_t : 10;
                pthread_mutex_lock(&g_flush.mu);
                int rc = 0;
                while (!g_flush.done && rc == 0)
                    rc = pthread_cond_timedwait(&g_flush.cv, &g_flush.mu,
                                                &ts);
                /* The timeout only abandons a worker still parked on
                 * PyGILState_Ensure. If the flush already started,
                 * wait it out (it's brief) — returning into exit()'s
                 * teardown mid-flush is the crash this code exists
                 * to prevent. */
                if (!g_flush.done && !g_flush.flushing)
                    g_flush.abandoned = 1;
                while (!g_flush.done && !g_flush.abandoned)
                    pthread_cond_wait(&g_flush.cv, &g_flush.mu);
                int done = g_flush.done;
                pthread_mutex_unlock(&g_flush.mu);
                if (done) {
                    pthread_join(t, NULL);
                } else {
                    pthread_detach(t);
                    fprintf(stderr,
                            "tpkt_shim: shutdown flush timed out (GIL "
                            "held elsewhere); exiting without flush\n");
                }
            }
        }
        pthread_mutex_lock(&g_wd.mu);
        /* Advance monotonically: two overlapping tpu_shutdown calls
         * (explicit shutdown racing the on_exit handler) must never
         * move done_gen backwards, or the newer attempt's watchdog
         * would keep waiting and _exit a healthy process. */
        if ((int)(g_wd.done_gen - wd_gen) < 0) g_wd.done_gen = wd_gen;
        pthread_cond_broadcast(&g_wd.cv);
        pthread_mutex_unlock(&g_wd.mu);
    }
    if (verbose()) fprintf(stderr, "tpkt_shim: shutdown\n");
}
