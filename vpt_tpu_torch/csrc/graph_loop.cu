// The dispatch's loops as CUDA-graph WHILE nodes, and their condition.
//
// Not a port of a TPU kernel: the JAX package compiles a dispatch
// (vpt_tpu/api.py _render_step) into one XLA program whose loops are
// lax.while_loop on the device, the wavefront loop
// (vpt_tpu/render/integrator.py) and the media loops inside it
// (vpt_tpu/render/volumes.py, vpt_tpu/render/atmosphere.py), with
// cond = (i < cap) & any(live).  The port's counterpart is one
// instantiated CUDA graph (vpt_tpu_torch/render/graphs.py): a WHILE
// conditional node whose body holds the iteration's captured torch graphs as
// child-graph nodes, each media loop a nested WHILE node.
//
// vpt_loop_cond_kernel is that condition.  One block reduces the loop's
// live mask (one bool per lane) to any(live), compares the loop's int64 step
// counter with its cap and sets the WHILE node's conditional handle to
// any(live) && steps < cap.  A kernel node of it sits just upstream of each
// WHILE node (with `reset` it first sets the counter to 0 and counts the
// loop as entered) and one at the end of each body, so, as in
// lax.while_loop, the condition is evaluated before the first body and after
// every body.  Each step it lets through adds 1 to the counter and to the
// loop's device tally (counts[1]; counts[0] counts the entries), which the
// host reads once after the launch.  Its plain version is
// render/loop.py:cond.
//
// What bounds it on the H100: the bytes of the mask, read once (262,144
// bytes for a 512x512 wavefront: 0.08 us at 3.35 TB/s).  One block is
// simple and needs no second pass, but one SM cannot draw the card's
// bandwidth; the launch of a node inside a WHILE body costs more than the
// read at these sizes.  The mask is read 16 bytes a thread at a time
// (torch allocates it 16-byte aligned; the wrapper checks).
//
// The host side builds the graph through the CUDA runtime (12.4 or later:
// child-graph and kernel nodes inside conditional bodies).  Graph handles
// are the CUDA driver's objects, so the graphs that torch's runtime
// captured are added here as child-graph nodes (cloned) and the exec is
// launched on torch's stream.  Every entry point returns the cudaError_t of the first
// call that failed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
vpt_loop_cond_kernel(const unsigned char* __restrict__ live, long long n, long long* steps, long long cap,
                     cudaGraphConditionalHandle handle, int reset, long long* counts) {
  int found = 0;
  const long long n16 = n / 16;
  const uint4* v = reinterpret_cast<const uint4*>(live);
  for (long long i = threadIdx.x; i < n16; i += kThreads) {
    const uint4 x = v[i];
    found |= (x.x | x.y | x.z | x.w) != 0u;
  }
  for (long long i = n16 * 16 + threadIdx.x; i < n; i += kThreads) found |= live[i] != 0;
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    long long s = reset ? 0 : *steps;
    const bool go = found && s < cap;
    if (reset) counts[0] += 1;
    if (go) {
      s += 1;
      counts[1] += 1;
    }
    *steps = s;
    cudaGraphSetConditional(handle, go ? 1u : 0u);
  }
}

const cudaGraphNode_t* deps(const cudaGraphNode_t& dep) { return dep ? &dep : nullptr; }
size_t n_deps(const cudaGraphNode_t& dep) { return dep ? 1 : 0; }

// Node types a conditional body may hold (CUDA 12.4 and later).
bool allowed(cudaGraphNodeType t) {
  return t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemcpy || t == cudaGraphNodeTypeMemset ||
         t == cudaGraphNodeTypeEmpty || t == cudaGraphNodeTypeGraph || t == cudaGraphNodeTypeConditional;
}

}  // namespace

extern "C" {

int vpt_graph_versions(int* cuda_driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(cuda_driver);
  if (e != cudaSuccess) return e;
  return cudaRuntimeGetVersion(runtime);
}

int vpt_graph_create(cudaGraph_t* graph) { return cudaGraphCreate(graph, 0); }

int vpt_graph_handle(cudaGraph_t graph, cudaGraphConditionalHandle* handle) {
  return cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
}

int vpt_graph_add_child(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraph_t child, cudaGraphNode_t* node) {
  return cudaGraphAddChildGraphNode(node, graph, deps(dep), n_deps(dep), child);
}

int vpt_graph_add_cond(cudaGraph_t graph, cudaGraphNode_t dep, const void* live, long long n, void* steps,
                       long long cap, cudaGraphConditionalHandle handle, int reset, void* counts,
                       cudaGraphNode_t* node) {
  long long* steps_p = static_cast<long long*>(steps);
  long long* counts_p = static_cast<long long*>(counts);
  void* args[] = {&live, &n, &steps_p, &cap, &handle, &reset, &counts_p};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(vpt_loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps(dep), n_deps(dep), &p);
}

int vpt_graph_add_while(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                        cudaGraph_t* body, cudaGraphNode_t* node) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, deps(dep), nullptr, n_deps(dep), &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, deps(dep), n_deps(dep), &p);
#endif
  if (e != cudaSuccess) return e;
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

// The type of the first node of `graph` (child graphs searched too) that a
// conditional body may not hold, or -1 in *type if there is none.
int vpt_graph_bad_node(cudaGraph_t graph, int* type) {
  *type = -1;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n && *type < 0; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (!allowed(t)) {
      *type = static_cast<int>(t);
    } else if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = static_cast<cudaError_t>(vpt_graph_bad_node(child, type));
    }
  }
  delete[] nodes;
  return e;
}

// Adds the kernel, memcpy and memset nodes of `graph` (child graphs searched
// too) to counts[0], counts[1] and counts[2]: the device work one launch of
// it runs, which a profiler sees as that many device events.
int vpt_graph_count_nodes(cudaGraph_t graph, long long* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (t == cudaGraphNodeTypeKernel) {
      ++counts[0];
    } else if (t == cudaGraphNodeTypeMemcpy) {
      ++counts[1];
    } else if (t == cudaGraphNodeTypeMemset) {
      ++counts[2];
    } else if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = static_cast<cudaError_t>(vpt_graph_count_nodes(child, counts));
    }
  }
  delete[] nodes;
  return e;
}

int vpt_graph_instantiate(cudaGraph_t graph, cudaGraphExec_t* exec) { return cudaGraphInstantiate(exec, graph, 0); }

int vpt_graph_launch(cudaGraphExec_t exec, cudaStream_t stream) {
  cudaError_t e = cudaGraphLaunch(exec, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Frees the exec (after its launches finish, if any are in flight) and the graph.
int vpt_graph_destroy(cudaGraph_t graph, cudaGraphExec_t exec) {
  cudaError_t e = exec ? cudaGraphExecDestroy(exec) : cudaSuccess;
  cudaError_t g = graph ? cudaGraphDestroy(graph) : cudaSuccess;
  return e != cudaSuccess ? e : g;
}

}  // extern "C"
