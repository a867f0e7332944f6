// C API for the BAOptimizer facade of the PyTorch / CUDA port — the
// embedding surface of the reference's ba_interface_example (reference
// include/ba_interface_example/BAOptimizer.h:127-135: BAOptimizer_Create /
// Add_CamVertex / Add_XYZVertex / Add_P2C3DEdge / Optimize / Dump_State...).
//
// The port's copy of native/ba_c_api.cpp, with the same C symbols: the shim
// embeds CPython and drives slam_plus_plus_tpu_torch.app.ba_optimizer, so a
// C or C++ host links this library and never sees Python (native/ba_c_test.c
// links against it unchanged).  It never imports jax.  The optimizer runs on
// the device named by the environment variable SLAMPP_DEVICE (default cuda;
// cpu asks for the CPU), and the package is imported from SLAMPP_ROOT (default
// the working directory).  A Python exception is printed and the call returns
// its failure value.  Built by g++ at first use with the interpreter's embed
// flags from sysconfig: slam_plus_plus_tpu_torch.ops._build.build_host("ba_c_api").

#include <Python.h>

#include <cstdio>
#include <cstdlib>

namespace {

struct BAHandle {
    PyObject *opt;   // slam_plus_plus_tpu_torch.app.ba_optimizer.BAOptimizer
};

bool ensure_python() {
    if (Py_IsInitialized())
        return true;
    Py_Initialize();
    // the repository root on sys.path, so the package imports from a plain
    // checkout
    PyRun_SimpleString(
        "import sys, os\n"
        "sys.path.insert(0, os.environ.get('SLAMPP_ROOT', os.getcwd()))\n");
    return Py_IsInitialized();
}

PyObject *call(PyObject *obj, const char *name, PyObject *args) {
    PyObject *fn = PyObject_GetAttrString(obj, name);
    if (!fn) {
        PyErr_Print();
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!out)
        PyErr_Print();
    return out;
}

PyObject *double_list(const double *v, int n) {
    PyObject *lst = PyList_New(n);
    for (int i = 0; i < n; ++i)
        PyList_SetItem(lst, i, PyFloat_FromDouble(v[i]));
    return lst;
}

}  // namespace

extern "C" {

// mirrors BAOptimizer_Create (BAOptimizer.h:127); use_schur stays in the
// signature for the callers' ABI and is ignored: the solvers take the Schur
// complement for BA by themselves
void *ba_optimizer_create(int /*use_schur*/) {
    if (!ensure_python())
        return nullptr;
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *mod = PyImport_ImportModule(
        "slam_plus_plus_tpu_torch.app.ba_optimizer");
    PyObject *cls = mod ? PyObject_GetAttrString(mod, "BAOptimizer") : nullptr;
    Py_XDECREF(mod);
    const char *device = getenv("SLAMPP_DEVICE");
    PyObject *args = PyTuple_New(0);
    PyObject *kwargs = Py_BuildValue("{s:s}", "device",
                                     device && *device ? device : "cuda");
    PyObject *opt = cls && args && kwargs ? PyObject_Call(cls, args, kwargs)
                                          : nullptr;
    Py_XDECREF(cls);
    Py_XDECREF(args);
    Py_XDECREF(kwargs);
    if (!opt) {
        PyErr_Print();
        PyGILState_Release(g);
        return nullptr;
    }
    BAHandle *h = new BAHandle{opt};
    PyGILState_Release(g);
    return h;
}

void ba_optimizer_destroy(void *hv) {
    if (!hv)
        return;
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    Py_XDECREF(h->opt);
    PyGILState_Release(g);
    delete h;
}

// mirrors BAOptimizer_Add_XYZVertex
int ba_optimizer_add_xyz_vertex(void *hv, long id, const double xyz[3]) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(h->opt, "add_xyz_vertex",
                         Py_BuildValue("(lN)", id, double_list(xyz, 3)));
    int ok = out != nullptr;
    Py_XDECREF(out);
    PyGILState_Release(g);
    return ok;
}

// mirrors BAOptimizer_Add_CamVertex (g2o VERTEX_CAM layout:
// pos3 + quat_xyzw + fx fy cx cy d)
int ba_optimizer_add_cam_vertex(void *hv, long id, const double pos3[3],
                                const double quat_xyzw[4],
                                const double intrinsics5[5]) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(
        h->opt, "add_cam_vertex_g2o",
        Py_BuildValue("(lNNddddd)", id, double_list(pos3, 3),
                      double_list(quat_xyzw, 4), intrinsics5[0],
                      intrinsics5[1], intrinsics5[2], intrinsics5[3],
                      intrinsics5[4]));
    int ok = out != nullptr;
    Py_XDECREF(out);
    PyGILState_Release(g);
    return ok;
}

// mirrors BAOptimizer_Add_P2C3DEdge (info is row-major 2x2)
int ba_optimizer_add_p2c_edge(void *hv, long point_id, long cam_id,
                              const double uv[2], const double info2x2[4]) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *info = PyList_New(2);
    PyList_SetItem(info, 0, double_list(info2x2, 2));
    PyList_SetItem(info, 1, double_list(info2x2 + 2, 2));
    PyObject *out = call(h->opt, "add_p2c_edge",
                         Py_BuildValue("(llNN)", point_id, cam_id,
                                       double_list(uv, 2), info));
    int ok = out != nullptr;
    Py_XDECREF(out);
    PyGILState_Release(g);
    return ok;
}

// mirrors BAOptimizer_Optimize; returns the final chi2 (or -1 on error)
double ba_optimizer_optimize(void *hv, int max_iterations) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(h->opt, "optimize",
                         Py_BuildValue("(i)", max_iterations));
    double chi2 = -1.0;
    if (out) {
        // optimize() returns (chi2, iters)
        PyObject *c = PySequence_GetItem(out, 0);
        if (c) {
            chi2 = PyFloat_AsDouble(c);
            Py_DECREF(c);
        }
        Py_DECREF(out);
    }
    PyGILState_Release(g);
    return chi2;
}

double ba_optimizer_chi2(void *hv) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(h->opt, "chi2", PyTuple_New(0));
    double chi2 = out ? PyFloat_AsDouble(out) : -1.0;
    Py_XDECREF(out);
    PyGILState_Release(g);
    return chi2;
}

// copies a vertex state into out (size n); returns the copied length
int ba_optimizer_vertex_state(void *hv, long id, double *out_buf, int n) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(h->opt, "vertex_state", Py_BuildValue("(l)", id));
    int m = 0;
    if (out) {
        PyObject *seq = PySequence_Fast(out, "state");
        if (seq) {
            m = (int)PySequence_Fast_GET_SIZE(seq);
            if (m > n)
                m = n;
            for (int i = 0; i < m; ++i)
                out_buf[i] = PyFloat_AsDouble(
                    PySequence_Fast_GET_ITEM(seq, i));
            Py_DECREF(seq);
        }
        Py_DECREF(out);
    }
    PyGILState_Release(g);
    return m;
}

// mirrors BAOptimizer_Dump_State
int ba_optimizer_dump_state(void *hv, const char *path) {
    BAHandle *h = static_cast<BAHandle *>(hv);
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *out = call(h->opt, "dump_state", Py_BuildValue("(s)", path));
    int ok = out != nullptr;
    Py_XDECREF(out);
    PyGILState_Release(g);
    return ok;
}

}  // extern "C"
