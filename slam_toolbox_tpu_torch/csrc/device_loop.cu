// lax.while_loop on the card: CUDA-graph WHILE conditional nodes around
// bodies that PyTorch captured.
//
// Replaces no Pallas kernel: it is the counterpart of the two
// lax.while_loops of slam_toolbox_tpu/solver/se2_solver.py lm_solve (the
// LM loop :457, its CG loop :414), which XLA runs on the device with one
// host round trip per call. The port captures each loop's pieces (the
// loop's init, the body, the LM step's head and tail) as CUDA graphs with
// torch.cuda.CUDAGraph(keep_graph=True) and builds one parent graph here:
//
//   [init] -> set_while(flag) -> WHILE { [body] -> set_while(flag) }
//
// where [x] is a child-graph node holding a captured graph, and a body may
// hold a WHILE node of its own (the CG loop inside the LM loop). set_while
// is a one-thread kernel that reads the loop's int64 flag on the device
// and sets the node's condition, so the condition is tested before the
// first iteration, as lax.while_loop tests it, and after each. The
// parent graph is instantiated once and launched on the caller's stream:
// a whole solve is one cudaGraphLaunch and no host read until its end.
//
// Bound: the loop adds one single-thread kernel an iteration; the bodies'
// kernels are the work. Conditional nodes need a CUDA 12.3 or later
// toolkit and driver; a body may hold only kernel, memset, memcpy,
// child-graph and conditional nodes (dl_check_body names any other).
//
// Interface: graphs are passed as their cudaGraph_t handles (PyTorch's
// raw_cuda_graph()). A graph's nodes are appended in order, each after
// the one before it. Every function returns a cudaError_t (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>
#include <unordered_map>

namespace {

__global__ void set_while_kernel(cudaGraphConditionalHandle handle,
                                 const long long* flag) {
    cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

struct Open {
    cudaGraphNode_t last = nullptr;   // the node the next one follows
    cudaGraphConditionalHandle handle = 0;  // a WHILE body's: its loop's
    const long long* flag = nullptr;
    cudaGraph_t root = nullptr;       // the parent graph it belongs to
};

std::mutex mu;
std::unordered_map<cudaGraph_t, Open> open_graphs;

cudaError_t append(cudaGraph_t g, cudaGraphNode_t node) {
    open_graphs[g].last = node;
    return cudaSuccess;
}

cudaError_t add_set_while(cudaGraph_t g, cudaGraphConditionalHandle h,
                          const long long* flag) {
    Open& o = open_graphs[g];
    cudaKernelNodeParams p = {};
    void* args[] = {&h, &flag};
    p.func = (void*)set_while_kernel;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    cudaGraphNode_t node;
    cudaError_t e = cudaGraphAddKernelNode(&node, g, o.last ? &o.last : nullptr,
                                           o.last ? 1 : 0, &p);
    if (e != cudaSuccess) return e;
    return append(g, node);
}

const char* type_name(cudaGraphNodeType t) {
    switch (t) {
        case cudaGraphNodeTypeKernel: return "kernel";
        case cudaGraphNodeTypeMemcpy: return "memcpy";
        case cudaGraphNodeTypeMemset: return "memset";
        case cudaGraphNodeTypeHost: return "host";
        case cudaGraphNodeTypeGraph: return "child graph";
        case cudaGraphNodeTypeEmpty: return "empty";
        case cudaGraphNodeTypeWaitEvent: return "event wait";
        case cudaGraphNodeTypeEventRecord: return "event record";
        case cudaGraphNodeTypeExtSemaphoreSignal: return "semaphore signal";
        case cudaGraphNodeTypeExtSemaphoreWait: return "semaphore wait";
        case cudaGraphNodeTypeMemAlloc: return "memory allocation";
        case cudaGraphNodeTypeMemFree: return "memory free";
        case cudaGraphNodeTypeConditional: return "conditional";
        default: return "unknown";
    }
}

}  // namespace

extern "C" {

// The runtime this library was built with and the driver's, as
// cudaRuntimeGetVersion and cudaDriverGetVersion give them.
int dl_versions(int* runtime, int* driver) {
    cudaError_t e = cudaRuntimeGetVersion(runtime);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDriverGetVersion(driver);
}

const char* dl_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Checks that every node of `g` (and of its child graphs) may sit in a
// conditional node's body; on the first that may not, returns
// cudaErrorNotSupported and writes its type into msg.
int dl_check_body(void* g, char* msg, int len) {
    size_t count = 0;
    cudaError_t e = cudaGraphGetNodes((cudaGraph_t)g, nullptr, &count);
    if (e != cudaSuccess) return (int)e;
    cudaGraphNode_t* nodes = new cudaGraphNode_t[count > 0 ? count : 1];
    e = cudaGraphGetNodes((cudaGraph_t)g, nodes, &count);
    for (size_t k = 0; e == cudaSuccess && k < count; ++k) {
        cudaGraphNodeType t;
        e = cudaGraphNodeGetType(nodes[k], &t);
        if (e != cudaSuccess) break;
        if (t == cudaGraphNodeTypeGraph) {
            cudaGraph_t child;
            e = cudaGraphChildGraphNodeGetGraph(nodes[k], &child);
            if (e == cudaSuccess) e = (cudaError_t)dl_check_body(child, msg, len);
        } else if (t != cudaGraphNodeTypeKernel &&
                   t != cudaGraphNodeTypeMemcpy &&
                   t != cudaGraphNodeTypeMemset &&
                   t != cudaGraphNodeTypeEmpty &&
                   t != cudaGraphNodeTypeConditional) {
            snprintf(msg, len, "a %s node (node %zu of %zu)", type_name(t), k,
                     count);
            e = cudaErrorNotSupported;
        }
    }
    delete[] nodes;
    return (int)e;
}

// A new empty parent graph.
int dl_graph_create(void** graph_out) {
    cudaGraph_t g;
    cudaError_t e = cudaGraphCreate(&g, 0);
    if (e != cudaSuccess) return (int)e;
    std::lock_guard<std::mutex> lock(mu);
    open_graphs[g].root = g;
    *graph_out = g;
    return 0;
}

// Appends a child-graph node holding a copy of `child` to `graph`.
int dl_append_child(void* graph, void* child) {
    std::lock_guard<std::mutex> lock(mu);
    cudaGraph_t g = (cudaGraph_t)graph;
    Open& o = open_graphs[g];
    cudaGraphNode_t node;
    cudaError_t e = cudaGraphAddChildGraphNode(
        &node, g, o.last ? &o.last : nullptr, o.last ? 1 : 0,
        (cudaGraph_t)child);
    if (e != cudaSuccess) return (int)e;
    return (int)append(g, node);
}

// Appends set_while(flag) and a WHILE node to `graph`; returns the node's
// body graph, which the caller fills with dl_append_child and
// dl_append_while and closes with dl_end_while. `flag` points to an int64
// on the device.
int dl_append_while(void* graph, const void* flag, void** body_out) {
    std::lock_guard<std::mutex> lock(mu);
    cudaGraph_t g = (cudaGraph_t)graph;
    cudaGraphConditionalHandle h;
    cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (e != cudaSuccess) return (int)e;
    const long long* f = (const long long*)flag;
    e = add_set_while(g, h, f);
    if (e != cudaSuccess) return (int)e;
    Open& o = open_graphs[g];
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t node;
    e = cudaGraphAddNode(&node, g, &o.last, 1, &p);
    if (e != cudaSuccess) return (int)e;
    append(g, node);
    cudaGraph_t body = p.conditional.phGraph_out[0];
    Open& b = open_graphs[body];
    b.handle = h;
    b.flag = f;
    b.root = open_graphs[g].root;
    *body_out = body;
    return 0;
}

// Closes a WHILE body: appends set_while on its loop's flag.
int dl_end_while(void* body) {
    std::lock_guard<std::mutex> lock(mu);
    cudaGraph_t b = (cudaGraph_t)body;
    auto it = open_graphs.find(b);
    if (it == open_graphs.end() || it->second.flag == nullptr)
        return (int)cudaErrorInvalidValue;
    return (int)add_set_while(b, it->second.handle, it->second.flag);
}

// Instantiates a parent graph.
int dl_instantiate(void* graph, void** exec_out) {
    cudaGraphExec_t x;
    cudaError_t e = cudaGraphInstantiate(&x, (cudaGraph_t)graph, 0);
    if (e != cudaSuccess) return (int)e;
    *exec_out = x;
    return 0;
}

int dl_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Destroys a parent graph (its bodies with it) and its instance, if any.
int dl_destroy(void* graph, void* exec) {
    std::lock_guard<std::mutex> lock(mu);
    cudaGraph_t g = (cudaGraph_t)graph;
    for (auto it = open_graphs.begin(); it != open_graphs.end();) {
        it = it->second.root == g ? open_graphs.erase(it) : std::next(it);
    }
    cudaError_t e = cudaSuccess;
    if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    cudaError_t e2 = cudaGraphDestroy(g);
    return (int)(e != cudaSuccess ? e : e2);
}

}  // extern "C"
