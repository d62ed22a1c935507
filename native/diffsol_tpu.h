/* diffsol_tpu C ABI (role of reference crates/diffsol-c: the extern "C"
 * surface over the solver framework, ode_c.rs:181-1200, error_c.rs,
 * host_array_c.rs).  The library embeds CPython and drives the
 * diffsol_tpu.capi_host module; models are supplied as DiffSL text exactly
 * like the reference's diffsol_ode_new_jit.
 *
 * Conventions: functions return 0 on success, -1 on error (fetch the
 * message with diffsol_last_error_message, thread-local).  Arrays are
 * caller-allocated, row-major f64.
 */
#ifndef DIFFSOL_TPU_H
#define DIFFSOL_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- runtime lifecycle ---- */
int diffsol_init(void);
void diffsol_shutdown(void);

/* ---- errors (reference error_c.rs:54-119) ---- */
const char *diffsol_last_error_message(void);
void diffsol_clear_last_error(void);
/* NULL / 0 when no error is set; file/line locate the recording site. */
const char *diffsol_error(void);
int diffsol_error_code(void);
const char *diffsol_last_error_file(void);
unsigned diffsol_last_error_line(void);

/* ---- allocation helpers (reference string_c.rs) ---- */
char *diffsol_alloc_string(size_t size);
void diffsol_free_string(char *ptr, size_t size);
void *diffsol_alloc(size_t size, size_t align);
void diffsol_free(void *ptr, size_t size, size_t align);

/* ---- ode handle lifecycle (reference ode_c.rs:284-341) ---- */
/* Build from DiffSL text; returns handle > 0, or 0 on error. */
int64_t diffsol_ode_new_jit(const char *diffsl_code);
/* Load a model from an external Python module file defining rhs(t,y,p),
 * init(t,p) and optional mass/root/reset/out/params/use_coloring (the
 * dynamic-model analog of the reference's DiffSL cdylib dlopen,
 * solve.rs:324). */
int64_t diffsol_ode_new_external_dynamic(const char *path);
/* Statically-linked model symbols have no equivalent in the
 * embedded-CPython host: always fails with an explanatory error. */
int64_t diffsol_ode_new_external(int matrix_type, int linear_solver,
                                 int ode_solver, const void *rhs_state_deps,
                                 size_t rhs_state_deps_len,
                                 const void *rhs_input_deps,
                                 size_t rhs_input_deps_len,
                                 const void *mass_state_deps,
                                 size_t mass_state_deps_len);
void diffsol_ode_free(int64_t ode);
/* Extension: drop in-memory compiled executables (call
 * periodically from long-lived processes; handles stay valid). */
void diffsol_clear_caches(void);

/* ---- settings (reference ode_c.rs:733-1100) ---- */
int diffsol_ode_set_rtol(int64_t ode, double v);
int diffsol_ode_get_rtol(int64_t ode, double *out);
int diffsol_ode_set_atol(int64_t ode, double v);
int diffsol_ode_get_atol(int64_t ode, double *out);
int diffsol_ode_set_t0(int64_t ode, double v);
int diffsol_ode_get_t0(int64_t ode, double *out);
int diffsol_ode_set_h0(int64_t ode, double v);
int diffsol_ode_get_h0(int64_t ode, double *out);
int diffsol_ode_set_params(int64_t ode, const double *p, int64_t len);
int diffsol_ode_get_params(int64_t ode, double *out, int64_t cap,
                           int64_t *len);
/* 0 = bdf, 1 = esdirk34, 2 = tr_bdf2, 3 = tsit45
 * (reference ode_solver_type.rs:34-39) */
int diffsol_ode_set_ode_solver(int64_t ode, int value);
int diffsol_ode_get_ode_solver(int64_t ode, int *out);
/* 0 = default, 1 = lu, 2 = klu (rejected: no KLU in this build)
 * (reference linear_solver_type.rs:15-19) */
int diffsol_ode_set_linear_solver(int64_t ode, int value);
int diffsol_ode_get_linear_solver(int64_t ode, int *out);
/* 0 = f32, 1 = f64 (reference scalar_type.rs:11-14).  The C data boundary
 * stays double either way; f32 selects the device solve precision. */
int diffsol_ode_set_scalar_type(int64_t ode, int value);
int diffsol_ode_get_scalar_type(int64_t ode, int *out);

/* ---- introspection ---- */
int diffsol_ode_nstates(int64_t ode, int64_t *out);
int diffsol_ode_nparams(int64_t ode, int64_t *out);
int diffsol_ode_nout(int64_t ode, int64_t *out);

/* ---- op evaluation (reference ode_c.rs:389-511) ---- */
int diffsol_ode_y0(int64_t ode, double *out, int64_t cap);
int diffsol_ode_rhs(int64_t ode, double t, const double *y, int64_t n,
                    double *out);
int diffsol_ode_rhs_jac_mul(int64_t ode, double t, const double *y,
                            const double *v, int64_t n, double *out);

/* ---- solves (reference ode_c.rs:512-623) ---- */
/* ys_out must hold neval * nstates doubles (row-major: point-major). */
int diffsol_ode_solve_dense(int64_t ode, const double *t_eval, int64_t neval,
                            int64_t max_steps, double *ys_out,
                            int *stop_reason);
/* Adaptive solve recording every internal step: ts_out holds cap_points,
 * ys_out cap_points * nstates; *npoints receives the valid count. */
int diffsol_ode_solve(int64_t ode, double t_final, int64_t max_steps,
                      double *ts_out, double *ys_out, int64_t cap_points,
                      int64_t *npoints, int *stop_reason);
/* Forward sensitivities: sens_out holds nparams * neval * nstates. */
int diffsol_ode_solve_fwd_sens(int64_t ode, const double *t_eval,
                               int64_t neval, double *ys_out,
                               double *sens_out);
/* Adjoint gradient (reference solve.rs solve_adjoint_fwd/_bkwd): dgdu is
 * dG/du at the eval points (neval * nstates, row-major); grad_out receives
 * dG/dp (nparams). */
int diffsol_ode_solve_adjoint(int64_t ode, const double *t_eval,
                              int64_t neval, const double *dgdu,
                              int64_t max_steps, double *ys_out,
                              double *grad_out);

/* ---- integrate_out + optional tolerance groups (ode_c.rs parity) ---- */
int diffsol_ode_set_integrate_out(int64_t ode, int value);
int diffsol_ode_get_integrate_out(int64_t ode, int *out);
/* sens/out/param rtol/atol: get returns NaN when the group is unset;
 * setting NaN clears it. */
int diffsol_ode_set_sens_rtol(int64_t ode, double v);
int diffsol_ode_get_sens_rtol(int64_t ode, double *out);
int diffsol_ode_set_sens_atol(int64_t ode, double v);
int diffsol_ode_get_sens_atol(int64_t ode, double *out);
int diffsol_ode_set_out_rtol(int64_t ode, double v);
int diffsol_ode_get_out_rtol(int64_t ode, double *out);
int diffsol_ode_set_out_atol(int64_t ode, double v);
int diffsol_ode_get_out_atol(int64_t ode, double *out);
int diffsol_ode_set_param_rtol(int64_t ode, double v);
int diffsol_ode_get_param_rtol(int64_t ode, double *out);
int diffsol_ode_set_param_atol(int64_t ode, double v);
int diffsol_ode_get_param_atol(int64_t ode, double *out);

/* ---- solver / consistent-IC options (ode_options_c.rs parity; the ode
 * handle doubles as the options handle -- reads/writes go through to the
 * next solve; integer fields are carried as doubles) ---- */
#define DIFFSOL_DECLARE_OPTION(prefix, name)                                \
    int prefix##_get_##name(int64_t ode, double *out);                      \
    int prefix##_set_##name(int64_t ode, double v);
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, max_nonlinear_solver_iterations)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, max_error_test_failures)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, max_nonlinear_solver_failures)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, update_jacobian_after_steps)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, update_rhs_jacobian_after_steps)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, threshold_to_update_jacobian)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, threshold_to_update_rhs_jacobian)
DIFFSOL_DECLARE_OPTION(diffsol_ode_options, min_timestep)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, use_linesearch)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, max_linesearch_iterations)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, max_newton_iterations)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, max_linear_solver_setups)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, step_reduction_factor)
DIFFSOL_DECLARE_OPTION(diffsol_ic_options, armijo_constant)
#undef DIFFSOL_DECLARE_OPTION

/* ---- quadrature-output solve (requires integrate_out) ---- */
/* gs_out must hold neval * nout doubles. */
int diffsol_ode_solve_dense_out(int64_t ode, const double *t_eval,
                                int64_t neval, int64_t max_steps,
                                double *gs_out, int64_t *nout,
                                int *stop_reason);

/* ---- type-enumeration helpers (reference *_type_count/name/is_valid) ---- */
#define DIFFSOL_DECLARE_TYPE_ENUM(prefix)                                   \
    int prefix##_count(void);                                               \
    int prefix##_is_valid(int value);                                       \
    int prefix##_name(int value, char *out, int64_t cap);
DIFFSOL_DECLARE_TYPE_ENUM(diffsol_ode_solver_type)
DIFFSOL_DECLARE_TYPE_ENUM(diffsol_linear_solver_type)
DIFFSOL_DECLARE_TYPE_ENUM(diffsol_scalar_type)
DIFFSOL_DECLARE_TYPE_ENUM(diffsol_matrix_type)
DIFFSOL_DECLARE_TYPE_ENUM(diffsol_jit_backend_type)
#undef DIFFSOL_DECLARE_TYPE_ENUM

/* ---- host-array views (reference host_array_c.rs; dtype 1 = f64) ---- */
/* Materialize a dense solve as a solver-owned array; returns handle > 0. */
int64_t diffsol_ode_solve_dense_array(int64_t ode, const double *t_eval,
                                      int64_t neval, int64_t max_steps,
                                      int *stop_reason);
int64_t diffsol_host_array_ndim(int64_t arr);
int64_t diffsol_host_array_dim(int64_t arr, int64_t i);
int64_t diffsol_host_array_stride(int64_t arr, int64_t i);
int diffsol_host_array_dtype(int64_t arr);
double *diffsol_host_array_ptr(int64_t arr);
void diffsol_host_array_free(int64_t arr);
/* Allocate a zeroed 1-D host array (dtype 1 = f64); free a list of
 * handles (reference host_array_c.rs:13, boxed_host_array_list). */
int64_t diffsol_host_array_alloc_vector(int64_t len, int dtype);
void diffsol_host_array_list_free(const int64_t *handles, int64_t len);

/* ---- options handles (reference ode_c.rs:343-380; the returned options
 * handle aliases the ode handle -- field accessors write through to the
 * live solve -- and the frees are no-ops) ---- */
int diffsol_ode_get_options(int64_t ode, int64_t *out_options);
int diffsol_ode_get_ic_options(int64_t ode, int64_t *out_options);
void diffsol_ode_options_free(int64_t options);
void diffsol_ic_options_free(int64_t options);

/* ---- matrix-type introspection (reference ode_c.rs:624); returns the
 * index into diffsol_matrix_type_name of the BUILT problem's solver-tier
 * layout: 0 dense, 1 banded, 2 blockdiag, 3 matrix_free ---- */
int diffsol_ode_get_matrix_type(int64_t ode);

/* ---- solution wrappers (reference solution_wrapper_c.rs: a solve result
 * owned by a handle; ts/ys/sens materialize as host arrays) ---- */
/* Returns solution handle > 0, or 0 on error.  with_sens != 0 also
 * records forward sensitivities (one host array per parameter). */
int64_t diffsol_ode_solve_solution(int64_t ode, const double *t_eval,
                                   int64_t neval, int64_t max_steps,
                                   int with_sens, int *stop_reason);
int diffsol_solution_wrapper_get_ts(int64_t solution, int64_t *out_array);
int diffsol_solution_wrapper_get_ys(int64_t solution, int64_t *out_array);
int diffsol_solution_wrapper_get_sens(int64_t solution, int64_t *out_handles,
                                      int64_t cap, int64_t *out_len);
void diffsol_solution_wrapper_free(int64_t solution);

#ifdef __cplusplus
}
#endif

#endif /* DIFFSOL_TPU_H */
